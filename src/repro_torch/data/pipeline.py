"""Federated data: per-client shards held on the host as numpy arrays.

The port's counterpart of ``repro.data.pipeline``.  Shards stay numpy on
the host; the executors upload each round's stacked batches to the device.
``sample_cohort`` consumes the numpy generator exactly as the reference
does, so one seed samples the same cohorts in both packages.

``ClientSlabStore`` is the device-resident tier of the placement layer:
zero-padded per-client slabs (``make_slab``) as tensors on a device, an LRU
cap, pins, moves between devices, the multi-host ownership gate, and the
hooks the population tier couples to (``drop``, ``on_evict``).  The
shard_map executor fills it (``core.executor.ShardMapExecutor``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.data.dirichlet import dirichlet_partition, partition_stats


@dataclasses.dataclass
class ClientData:
    x: np.ndarray
    y: np.ndarray

    @property
    def n(self) -> int:
        return len(self.y)


@dataclasses.dataclass
class FederatedData:
    clients: list[ClientData]
    test_x: np.ndarray
    test_y: np.ndarray
    label_matrix: np.ndarray     # (K, C) counts, paper Fig.3

    @property
    def n_clients(self) -> int:
        return len(self.clients)

    @property
    def total_n(self) -> int:
        return sum(c.n for c in self.clients)

    @classmethod
    def from_arrays(cls, x: np.ndarray, y: np.ndarray, test_x, test_y,
                    n_clients: int, alpha: float, seed: int = 0):
        parts = dirichlet_partition(y, n_clients, alpha, seed=seed)
        clients = [ClientData(x[idx], y[idx]) for idx in parts]
        return cls(clients, test_x, test_y, partition_stats(y, parts))

    def client_n(self, cid: int) -> int:
        return self.clients[int(cid)].n

    def sample_cohort(self, rng: np.random.Generator, k: int,
                      exclude=None) -> np.ndarray:
        """Uniform draw of ``k`` distinct clients, as the reference draws:
        one ``rng.choice`` over the whole population, or over the sorted
        ids not in ``exclude`` (the async loop's in-flight clients)."""
        if not exclude:
            return rng.choice(self.n_clients, size=k, replace=False)
        idle = np.setdiff1d(np.arange(self.n_clients, dtype=np.int64),
                            np.fromiter(exclude, np.int64))
        return idle[rng.choice(len(idle), size=k, replace=False)]


def num_batches(n: int, batch_size: int, epochs: int) -> int:
    bs = min(batch_size, n)
    return epochs * int(np.ceil(n / bs))


# ---------------------------------------------------------------------------
# device-resident slabs (the placement layer's hot tier)
# ---------------------------------------------------------------------------

SLAB_QUANT = 64   # slab rows are multiples of this, as the reference's


def slab_rows(n: int) -> int:
    """Quantized slab row count: ``n`` rounded up to ``SLAB_QUANT``."""
    return max(SLAB_QUANT, int(-(-n // SLAB_QUANT)) * SLAB_QUANT)


def make_slab(data: ClientData, rows: int) -> tuple[np.ndarray, np.ndarray]:
    """One client's shard zero-padded to ``rows`` (labels as int32); the
    padded rows reach no loss (masks and batch picks skip them)."""
    assert rows >= data.n, (rows, data.n)
    x = np.zeros((rows,) + data.x.shape[1:], data.x.dtype)
    y = np.zeros((rows,), np.int32)
    x[:data.n] = data.x
    y[:data.n] = data.y
    return x, y


class ClientSlabStore:
    """Device-resident per-client slabs, keyed by stable client id.

    ``get(cid, data, device)`` returns ``{"x", "y", "n", "rows",
    "device"}`` with ``x``/``y`` tensors on ``device``.  A resident client
    on that device is a hit (no host transfer); a resident client asked
    for on another device is moved device to device (``device_moves``),
    never uploaded from the host again; ``cid=None`` caches nothing (every
    call is a fresh upload).  ``max_resident`` caps the resident clients,
    evicting the least recently used (``None``: unbounded).

    The population tier couples to the store three ways: ``drop(cid)``
    invalidates a slab when the client leaves the warm host tier (counted
    in ``drops``, not ``evictions``), ``on_evict(cid, entry)`` observes cap
    evictions, and ids in ``pinned`` (shared by reference with the
    population store) are never cap-evicted: with more pinned clients than
    the cap the store exceeds it.

    Under multi-host placement (``population.placement``) a host's
    devices own only its shards: ``owns`` is that membership predicate,
    and the store refuses to materialize a slab for a client it does not
    own, so a placement bug raises here instead of doubling the host's
    device memory.
    """

    def __init__(self, max_resident: Optional[int] = None, on_evict=None,
                 owns=None):
        self.slabs: "collections.OrderedDict" = collections.OrderedDict()
        self.max_resident = max_resident
        self.on_evict = on_evict        # called (cid, entry) on cap eviction
        self.owns = owns                # optional cid -> bool ownership gate
        self.pinned: set = set()        # exempt from cap eviction
        self.host_transfers = 0
        self.device_moves = 0
        self.hits = 0
        self.evictions = 0
        self.drops = 0                  # explicit drop(cid) invalidations
        self.peak_resident = 0          # high-water of resident slabs

    def get(self, cid, data: ClientData, device) -> dict:
        if self.owns is not None and cid is not None and not self.owns(cid):
            raise ValueError(
                f"slab store: client {cid} is not owned by this host's "
                f"placement: the multi-host round must slice the cohort "
                f"to owned clients before materializing")
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # "cuda" and "cuda:0" are one card: a hit, not a new upload
            device = torch.device("cuda", torch.cuda.current_device())
        entry = self.slabs.get(cid) if cid is not None else None
        if entry is not None and entry["n"] == data.n:
            self.slabs.move_to_end(cid)
            if entry["device"] == device:
                self.hits += 1
                return entry
            entry = dict(entry, device=device, x=entry["x"].to(device),
                         y=entry["y"].to(device))
            self.slabs[cid] = entry
            self.device_moves += 1
            return entry
        rows = slab_rows(data.n)
        x, y = make_slab(data, rows)
        entry = {"device": device, "x": torch.from_numpy(x).to(device),
                 "y": torch.from_numpy(y).to(device), "n": data.n,
                 "rows": rows}
        if cid is not None:
            self.slabs[cid] = entry
            self.slabs.move_to_end(cid)
            while (self.max_resident is not None
                   and len(self.slabs) > self.max_resident):
                victim = next((k for k in self.slabs
                               if k not in self.pinned), None)
                if victim is None:      # everything pinned: exceed the cap
                    break
                evicted = self.slabs.pop(victim)
                self.evictions += 1
                if self.on_evict is not None:
                    self.on_evict(victim, evicted)
            self.peak_resident = max(self.peak_resident, len(self.slabs))
        self.host_transfers += 1
        return entry

    def drop(self, cid) -> bool:
        """Invalidate ``cid``'s slab: counted in ``drops``, never in
        ``evictions``, and ``on_evict`` does not fire.  The client uploads
        again on its next ``get``."""
        if self.slabs.pop(cid, None) is None:
            return False
        self.drops += 1
        return True

    def stats(self) -> dict:
        return {"resident_clients": len(self.slabs),
                "host_transfers": self.host_transfers,
                "device_moves": self.device_moves, "hits": self.hits,
                "evictions": self.evictions, "drops": self.drops,
                "peak_resident": self.peak_resident}
