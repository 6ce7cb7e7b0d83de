"""The ``Population`` facade: what ``run_federated(population=...)`` takes.

The port of ``repro.population.population``.  It answers the part of
``FederatedData`` the FL loop touches (``n_clients``, ``clients[cid]``,
``test_x``, ``test_y``, ``sample_cohort``, ``client_n``) from the
three-tier store and the hierarchical sampler, so the loop's per-round cost
and the process's peak host memory are O(cohort) and O(warm cap) whatever
the population's size.
``Population.from_federated(data)`` wraps an eager dataset: with one shard
its cohort sequence is the flat loop's, draw for draw.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional

import numpy as np

from repro_torch.core.algorithms import Algorithm
from repro_torch.population.placement import HostPlacement
from repro_torch.population.sampling import HierarchicalSampler
from repro_torch.population.sources import (ClientSource, InMemorySource,
                                            SyntheticClientSource)
from repro_torch.population.store import ClientStateStore, PopulationStore


class _ClientsView:
    """``population.clients[cid]``: indexing materializes through the warm
    tier; no other list behaviour, on purpose."""

    def __init__(self, store: PopulationStore):
        self._store = store

    def __getitem__(self, cid: int):
        return self._store.get(int(cid))

    def __len__(self) -> int:
        return self._store.n_clients


class Population:
    """A client population the FL loop samples and materializes lazily.

    Args:
      source: the cold tier (``repro_torch.population.sources``).
      test_x/test_y: the server's evaluation split (eager: one array).
      warm_cap: most clients materialized on the host (None: unbounded; a
        cross-device run sets it).
      state_warm_cap: the same cap for mutable per-client algorithm states
        (default ``warm_cap``); evicted states spill to ``state_dir`` (a
        temporary directory when unset) and reload when sampled again.
      placement: multi-host ownership (``population.placement``).
        ``warm_cap`` and ``state_warm_cap`` are global figures: with
        ``n_hosts`` hosts each process keeps ``cap // n_hosts``.  The
        sampler still draws over the whole population on every host (the
        same streams); a host materializes only the clients of the shards
        it owns.  ``n_hosts == 1`` (and ``None``) leave every path as it
        was.
    """

    def __init__(self, source: ClientSource, test_x, test_y, *,
                 warm_cap: Optional[int] = None,
                 state_warm_cap: Optional[int] = None,
                 state_dir: Optional[str] = None,
                 placement: Optional[HostPlacement] = None):
        self.placement = placement
        if placement is not None:
            warm_cap = placement.split_cap(warm_cap)
            if state_warm_cap is not None:
                state_warm_cap = placement.split_cap(state_warm_cap)
        self.store = PopulationStore(source, warm_cap=warm_cap)
        self.sampler = HierarchicalSampler(source.shard_sizes)
        self.clients = _ClientsView(self.store)
        self.test_x = np.asarray(test_x)
        self.test_y = np.asarray(test_y)
        self.state_warm_cap = (state_warm_cap if state_warm_cap is not None
                               else warm_cap)
        self.state_dir = state_dir
        self.state_store: Optional[ClientStateStore] = None

    # -- the FederatedData surface ----------------------------------------
    @property
    def n_clients(self) -> int:
        return self.store.n_clients

    @property
    def n_shards(self) -> int:
        return self.sampler.n_shards

    def client_n(self, cid: int) -> int:
        return self.store.client_n(cid)

    def max_client_n(self) -> int:
        """The largest client's example count, from the source's own bound
        where it has one (no client is materialized)."""
        fn = getattr(self.store.source, "max_client_n", None)
        if fn is not None:
            return int(fn())
        return int(max(self.store.source.client_n(c)
                       for c in range(self.n_clients)))

    def sample_cohort(self, rng: np.random.Generator, k: int,
                      exclude: Optional[Iterable[int]] = None) -> np.ndarray:
        return self.sampler.sample(rng, k, exclude)

    # -- multi-host placement -----------------------------------------------
    @property
    def multihost(self) -> bool:
        return self.placement is not None and self.placement.n_hosts > 1

    def owned(self, cid: int) -> bool:
        """Does this host's warm and hot tier own client ``cid``?"""
        if self.placement is None:
            return True
        return self.placement.owns_shard(self.sampler.shard_of(int(cid)))

    def probe_client(self):
        """Client 0 straight from the cold source: a host that does not own
        it must not pull it into its warm tier to probe shapes."""
        return self.store.source.client(0)

    # -- the loop's wiring --------------------------------------------------
    def make_client_states(self, algo: Algorithm,
                           global_params: Any) -> ClientStateStore:
        """The lazy per-client state store in place of the eager dict.

        It captures the initial global params (what the eager dict was
        built from); an algorithm that does not override
        ``update_client_state`` gets a store that re-inits on read and
        holds nothing, one that does the warm LRU and the disk spills."""
        mutable = (type(algo).update_client_state
                   is not Algorithm.update_client_state)
        self.state_store = ClientStateStore(
            lambda cid: algo.init_client_state(cid, global_params),
            mutable=mutable, warm_cap=self.state_warm_cap,
            spill_dir=self.state_dir, pinned=self.store.pinned)
        return self.state_store

    def attach_hot(self, slab_store) -> None:
        self.store.attach_hot(slab_store)

    def pin(self, cids: Iterable[int]) -> None:
        self.store.pin(cids)

    def unpin(self, cids: Iterable[int]) -> None:
        self.store.unpin(cids)

    def stats(self) -> dict:
        out = dict(self.store.stats(), n_shards=self.sampler.n_shards)
        if self.state_store is not None:
            out.update(self.state_store.stats())
        if self.placement is not None:
            out["host_id"] = self.placement.host_id
            out["n_hosts"] = self.placement.n_hosts
        return out

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_federated(cls, data, n_shards: int = 1, **kw) -> "Population":
        """Wrap an eager ``FederatedData``."""
        return cls(InMemorySource(data.clients, n_shards=n_shards),
                   data.test_x, data.test_y, **kw)

    @classmethod
    def synthetic(cls, n_clients: int, *, n_test: int = 256, seed: int = 0,
                  shard_size: int = 4096, warm_cap: Optional[int] = 256,
                  placement: Optional[HostPlacement] = None,
                  **source_kw) -> "Population":
        """A seeded synthetic population (``SyntheticClientSource``)."""
        src = SyntheticClientSource(n_clients, seed=seed,
                                    shard_size=shard_size, **source_kw)
        test_x, test_y = src.test_set(n_test)
        return cls(src, test_x, test_y, warm_cap=warm_cap,
                   placement=placement)
