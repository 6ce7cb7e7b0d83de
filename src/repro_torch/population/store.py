"""The warm host-RAM tier and the per-client algorithm-state tier.

The port of ``repro.population.store``.  ``PopulationStore`` sits between
a cold ``ClientSource`` (disk shards or a seeded generator, see
``repro_torch.population.sources``) and the device-resident
``ClientSlabStore`` (``repro_torch.data.pipeline``):

    cold   the source: O(population) capacity, O(1) host memory
    warm   an LRU of materialized ``ClientData`` capped at ``warm_cap``
           entries: the bound on peak host memory
    hot    the device slab store; attached, a client dropped from warm is
           ``drop()``-ed from the device too, and the slab store's LRU
           evictions count into the population's telemetry

Pinning: the async loop's in-flight clients must keep their shards and
states however many waves dispatch before their completions aggregate;
``pin(cids)`` exempts them from warm, hot and state-tier eviction until
``unpin``.  With more pinned clients than the cap a tier exceeds it
(``peak_warm`` records the excursion).

``ClientStateStore`` gives the per-client algorithm state the same
treatment, in one of two regimes chosen from the algorithm's class:

  * stateless (``update_client_state`` not overridden: FedAvg, FedProx,
    the KD family): states never change after init, so the store holds
    nothing and re-inits on every read from the captured initial global;
  * stateful (MOON, SCAFFOLD, FedDyn): a warm LRU capped at ``warm_cap``
    whose evicted states spill to per-client ``.npz`` files
    (``repro_torch.checkpoint.io``: to the host to be written, back to the
    run's device on reload) and reload on the client's next sample.

Torch tensors are mutable where the reference's jax arrays are not, so
``snapshot`` clones every tensor leaf: a state updated in place after a
checkpoint was cut cannot tear that checkpoint.
"""
from __future__ import annotations

import collections
import logging
import os
import tempfile
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import CORRUPT_ERRORS, load_pytree, save_pytree
from repro_torch.data.pipeline import ClientData
from repro_torch.population.sources import ClientSource
from repro_torch.tree import tree_map

_LOG = logging.getLogger("repro_torch.population")


def _evict_lru(od: "collections.OrderedDict", pinned: set):
    """Pop the least recently used entry not pinned (None if all are)."""
    for key in od:
        if key not in pinned:
            return key, od.pop(key)
    return None


class PopulationStore:
    """Cold-to-warm client materialization with a bounded working set."""

    def __init__(self, source: ClientSource,
                 warm_cap: Optional[int] = None):
        self.source = source
        self.warm: "collections.OrderedDict[int, ClientData]" = \
            collections.OrderedDict()
        self.warm_cap = warm_cap
        self.pinned: set[int] = set()
        self.hot = None                 # attached ClientSlabStore (or None)
        self.cold_loads = 0
        self.warm_hits = 0
        self.warm_evictions = 0
        self.hot_evictions = 0          # fed back by the slab store
        self.peak_warm = 0

    @property
    def n_clients(self) -> int:
        return self.source.n_clients

    def attach_hot(self, slab_store) -> None:
        """Couple the device tier: warm evictions drop the client's slab,
        slab-store cap evictions count into ``hot_evictions``, and the
        pinned set is shared by reference.  Pins the slab store held
        before merge into the shared set, and an ``on_evict`` it had is
        chained, not replaced."""
        self.hot = slab_store
        self.pinned.update(slab_store.pinned)
        slab_store.pinned = self.pinned
        prior = slab_store.on_evict

        def on_evict(cid, entry):
            self.hot_evictions += 1
            if prior is not None:
                prior(cid, entry)

        slab_store.on_evict = on_evict

    def get(self, cid: int) -> ClientData:
        cid = int(cid)
        data = self.warm.get(cid)
        if data is not None:
            self.warm.move_to_end(cid)
            self.warm_hits += 1
            return data
        data = self.source.client(cid)
        self.cold_loads += 1
        self.warm[cid] = data
        while self.warm_cap is not None and len(self.warm) > self.warm_cap:
            victim = _evict_lru(self.warm, self.pinned)
            if victim is None:          # everything pinned: exceed the cap
                break
            self.warm_evictions += 1
            if self.hot is not None:    # keep the tiers coherent top-down
                self.hot.drop(victim[0])
        # the high-water after eviction: above warm_cap only when pins
        # forced it
        self.peak_warm = max(self.peak_warm, len(self.warm))
        return data

    def client_n(self, cid: int) -> int:
        cid = int(cid)
        data = self.warm.get(cid)
        if data is not None:
            # a size read of a warm client is a use, as in get()
            self.warm.move_to_end(cid)
            self.warm_hits += 1
            return data.n
        return self.source.client_n(cid)

    def pin(self, cids: Iterable[int]) -> None:
        self.pinned.update(int(c) for c in cids)

    def unpin(self, cids: Iterable[int]) -> None:
        self.pinned.difference_update(int(c) for c in cids)

    def stats(self) -> dict:
        return {"warm_resident": len(self.warm), "warm_cap": self.warm_cap,
                "warm_hits": self.warm_hits, "cold_loads": self.cold_loads,
                "warm_evictions": self.warm_evictions,
                "hot_evictions": self.hot_evictions,
                "peak_warm": self.peak_warm, "pinned": len(self.pinned)}


def _copy_leaf(leaf: Any) -> Any:
    """A leaf by value: tensors cloned, numpy arrays copied."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    if isinstance(leaf, np.ndarray):
        return np.array(leaf, copy=True)
    return leaf


class ClientStateStore:
    """Per-client algorithm state with the same cold/warm discipline.

    Mapping-shaped (``states[cid]`` / ``states[cid] = new``), so the FL loop
    reads and writes it as it does the eager dict.
    """

    def __init__(self, init_fn: Callable[[int], Any], *, mutable: bool,
                 warm_cap: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 pinned: Optional[set] = None):
        self.init_fn = init_fn
        self.mutable = mutable
        self.warm: "collections.OrderedDict[int, Any]" = \
            collections.OrderedDict()
        self.warm_cap = warm_cap
        self.spill_dir = spill_dir
        self.pinned = pinned if pinned is not None else set()
        self.spilled: set[int] = set()
        self.state_inits = 0
        self.state_hits = 0
        self.state_spills = 0
        self.state_loads = 0
        self.state_corrupt_reinits = 0
        self.peak_warm = 0

    def _spill_path(self, cid: int) -> str:
        if self.spill_dir is None:
            self.spill_dir = tempfile.mkdtemp(prefix="repro_client_states_")
        return os.path.join(self.spill_dir, f"state_{cid:09d}.npz")

    def __getitem__(self, cid: int) -> Any:
        cid = int(cid)
        if not self.mutable:
            self.state_inits += 1
            return self.init_fn(cid)
        if cid in self.warm:
            self.warm.move_to_end(cid)
            self.state_hits += 1
            return self.warm[cid]
        if cid in self.spilled:
            try:
                state = load_pytree(self._spill_path(cid),
                                    like=self.init_fn(cid))
                self.state_loads += 1
            except CORRUPT_ERRORS as e:
                # a torn spill (a crash mid-save, a disk fault) must not
                # end the run: the client restarts from its initial state,
                # as if never sampled; counted and logged
                _LOG.warning("corrupt state spill for client %d (%s: %s); "
                             "re-initializing", cid, type(e).__name__, e)
                self.spilled.discard(cid)
                state = self.init_fn(cid)
                self.state_corrupt_reinits += 1
                self.state_inits += 1
        else:
            state = self.init_fn(cid)
            self.state_inits += 1
        self._put(cid, state)
        return state

    def __setitem__(self, cid: int, state: Any) -> None:
        if not self.mutable:
            return                      # init-constant states: nothing to
        self._put(int(cid), state)      # write back

    def _put(self, cid: int, state: Any) -> None:
        self.warm[cid] = state
        self.warm.move_to_end(cid)
        while self.warm_cap is not None and len(self.warm) > self.warm_cap:
            victim = _evict_lru(self.warm, self.pinned)
            if victim is None:
                break
            vcid, vstate = victim
            save_pytree(self._spill_path(vcid), vstate)
            self.spilled.add(vcid)
            self.state_spills += 1
        self.peak_warm = max(self.peak_warm, len(self.warm))

    def snapshot(self) -> dict:
        """The checkpoint payload: warm states by value (containers rebuilt,
        tensor leaves cloned), the spill tier by reference (the spilled
        ids and the spill directory).  A stateless store snapshots only
        its marker."""
        snap: dict = {"kind": "state_store", "mutable": self.mutable}
        if self.mutable:
            snap["warm_cids"] = [int(c) for c in self.warm]
            snap["warm_states"] = [tree_map(_copy_leaf, s)
                                   for s in self.warm.values()]
            snap["spilled"] = sorted(int(c) for c in self.spilled)
            snap["spill_dir"] = self.spill_dir
        return snap

    def restore(self, snap: dict) -> None:
        if bool(snap.get("mutable")) != self.mutable:
            raise ValueError(
                "the checkpointed state store's mutability does not match "
                "this run's algorithm: resume with the algorithm it was "
                "written under")
        if not self.mutable:
            return
        self.warm = collections.OrderedDict(
            zip([int(c) for c in snap["warm_cids"]], snap["warm_states"]))
        self.spilled = set(int(c) for c in snap["spilled"])
        spill_dir = snap.get("spill_dir")
        if self.spilled and (spill_dir is None
                             or not os.path.isdir(spill_dir)):
            raise ValueError(
                f"the checkpoint names spilled client states under "
                f"{spill_dir!r}, which is gone: pass state_dir= a durable "
                f"path for spills to survive restarts")
        if spill_dir is not None:
            self.spill_dir = spill_dir

    def stats(self) -> dict:
        return {"state_mutable": self.mutable,
                "state_warm": len(self.warm),
                "state_spilled": len(self.spilled),
                "state_inits": self.state_inits,
                "state_hits": self.state_hits,
                "state_spills": self.state_spills,
                "state_loads": self.state_loads,
                "state_corrupt_reinits": self.state_corrupt_reinits,
                "state_peak_warm": self.peak_warm}
