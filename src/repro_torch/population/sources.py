"""Cold-tier client sources: where a client's shard comes from.

The port of ``repro.population.sources``.  A ``ClientSource`` materializes
one client on demand; the population tier (``repro_torch.population.store``)
keeps a bounded warm working set on top, so peak host memory is O(warm
cap), never O(population).  Three sources:

    InMemorySource        wraps an eager ``list[ClientData]``
                          (``FederatedData.clients``): the bridge the
                          equivalence tests use, not a scaling route
    SyntheticClientSource client ``cid`` is a pure function of (seed, cid),
                          drawn from its own ``SeedSequence`` child stream;
                          nothing is stored.  The same seed gives the
                          reference's clients byte for byte
    DiskShardSource       per-shard ``.npy`` files opened ``mmap_mode="r"``
                          (written by ``write_population_shards``: atomic
                          replace, a JSON ``population.meta`` sidecar)

The reference writes its shard metadata as msgpack; the port writes JSON
(the card's host has no msgpack), so shard directories do not cross
between the packages, as checkpoints do not.

Every source exposes ``shard_sizes`` (contiguous client-id ranges: the
geometry ``HierarchicalSampler`` draws over) and ``client_n(cid)`` (the
client's example count without materializing its arrays: the async loop
prices local work for 1M clients from sizes alone).
"""
from __future__ import annotations

import collections
import json
import os
from typing import Iterator, Protocol, runtime_checkable

import numpy as np

from repro_torch.data.pipeline import ClientData

_META_NAME = "population.meta"


def _check_cid(cid: int, n_clients: int) -> None:
    """Every source raises the same IndexError for an id outside
    ``[0, n_clients)``: ``client(-1)`` must not wrap, and a synthetic
    source must not mint clients past the census."""
    if not (0 <= cid < n_clients):
        raise IndexError(f"client id {cid} out of range "
                         f"[0, {n_clients})")


def even_shard_sizes(n_clients: int, shard_size: int) -> np.ndarray:
    """Contiguous shards of ``shard_size`` clients (last one partial)."""
    if n_clients <= 0 or shard_size <= 0:
        raise ValueError(f"need positive n_clients/shard_size, got "
                         f"{n_clients}/{shard_size}")
    n_shards = -(-n_clients // shard_size)
    sizes = np.full(n_shards, shard_size, np.int64)
    sizes[-1] = n_clients - shard_size * (n_shards - 1)
    return sizes


@runtime_checkable
class ClientSource(Protocol):
    """Lazy per-client data: the population store's cold tier."""

    n_clients: int
    shard_sizes: np.ndarray     # contiguous client-id ranges

    def client(self, cid: int) -> ClientData:
        """Materialize client ``cid``'s full shard (fresh host arrays)."""
        ...

    def client_n(self, cid: int) -> int:
        """``client(cid).n`` without materializing the arrays."""
        ...


class InMemorySource:
    """Adapter over an eager client list (``FederatedData.clients``)."""

    def __init__(self, clients: list[ClientData], n_shards: int = 1):
        if not clients:
            raise ValueError("InMemorySource needs at least one client")
        self.clients = clients
        self.n_clients = len(clients)
        n_shards = min(n_shards, self.n_clients)
        self.shard_sizes = even_shard_sizes(
            self.n_clients, -(-self.n_clients // n_shards))

    def client(self, cid: int) -> ClientData:
        _check_cid(cid, self.n_clients)
        return self.clients[cid]

    def client_n(self, cid: int) -> int:
        _check_cid(cid, self.n_clients)
        return self.clients[cid].n

    def max_client_n(self) -> int:
        return int(max(c.n for c in self.clients))


class SyntheticClientSource:
    """Million-client populations from a seed: client ``cid`` comes from
    the child stream ``SeedSequence(entropy=seed, spawn_key=(cid,))``, so
    any client is reproducible alone and the source holds only the
    (num_classes, dim) class means and the rotation.

    The task is the TOY task's rotated Gaussian blobs
    (``repro_torch.data.synthetic.SyntheticTabularTask``) with per-client
    example counts uniform over ``[min_n, max_n]``: ragged, like a real
    cross-device population.
    """

    def __init__(self, n_clients: int, *, num_classes: int = 10,
                 dim: int = 16, min_n: int = 16, max_n: int = 48,
                 noise: float = 1.0, seed: int = 0, shard_size: int = 4096):
        if not (1 <= min_n <= max_n):
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"{min_n}/{max_n}")
        self.n_clients = n_clients
        self.num_classes = num_classes
        self.dim = dim
        self.min_n, self.max_n = min_n, max_n
        self.noise = noise
        self.seed = seed
        self.shard_sizes = even_shard_sizes(n_clients, shard_size)
        # the class geometry every client and the test split share
        mrng = np.random.default_rng(seed + 77)
        means = mrng.normal(0, 1, size=(num_classes, dim))
        means *= 2.0 / (np.linalg.norm(means, axis=1, keepdims=True) + 1e-9)
        rot, _ = np.linalg.qr(mrng.normal(0, 1, (dim, dim)))
        self._means, self._rot = means, rot

    def _rng(self, cid: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(cid,)))

    def client_n(self, cid: int) -> int:
        # the size is the client stream's first draw, so it is known
        # without generating the feature arrays
        _check_cid(cid, self.n_clients)
        return int(self._rng(cid).integers(self.min_n, self.max_n + 1))

    def max_client_n(self) -> int:
        # sizes are uniform over [min_n, max_n]: the bound is exact without
        # drawing a single client stream
        return self.max_n

    def client(self, cid: int) -> ClientData:
        _check_cid(cid, self.n_clients)
        rng = self._rng(cid)
        n = int(rng.integers(self.min_n, self.max_n + 1))
        labels = rng.integers(0, self.num_classes, size=n)
        x = self._means[labels] + rng.normal(0, self.noise, (n, self.dim))
        return ClientData((x @ self._rot).astype(np.float32),
                          labels.astype(np.int64))

    def test_set(self, n_test: int) -> tuple[np.ndarray, np.ndarray]:
        """A held-out evaluation split from the same class geometry."""
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed,
                                   spawn_key=(0x7E57,)))
        labels = rng.integers(0, self.num_classes, size=n_test)
        x = self._means[labels] + rng.normal(0, self.noise,
                                             (n_test, self.dim))
        return ((x @ self._rot).astype(np.float32),
                labels.astype(np.int64))


# ---------------------------------------------------------------------------
# on-disk shards
# ---------------------------------------------------------------------------

def _shard_paths(root: str, s: int) -> tuple[str, str, str]:
    return (os.path.join(root, f"shard_{s:05d}_x.npy"),
            os.path.join(root, f"shard_{s:05d}_y.npy"),
            os.path.join(root, f"shard_{s:05d}_off.npy"))


def _atomic_save(path: str, arr: np.ndarray) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:       # a file object: np.save appends no
        np.save(f, arr)              # suffix, so the replace target is
    os.replace(tmp, path)            # exactly what _shard() opens


def write_population_shards(root: str, clients: Iterator[ClientData], *,
                            shard_size: int = 1024) -> dict:
    """Write a client stream as per-shard memory-mappable ``.npy`` triples.

    Shard ``s`` holds its clients' examples row-concatenated
    (``shard_s_x.npy`` / ``shard_s_y.npy``) and an int64 offsets vector
    (``shard_s_off.npy``, ``clients_in_shard + 1`` long); the JSON
    ``population.meta`` records the shard sizes.  Every file lands by
    write-to-temp and ``os.replace``, so a crash mid-write leaves no
    partial shard that looks whole.  Returns the metadata.
    """
    os.makedirs(root, exist_ok=True)
    shard_sizes: list[int] = []
    pending_x: list[np.ndarray] = []
    pending_y: list[np.ndarray] = []

    def flush() -> None:
        if not pending_x:
            return
        px, py, poff = _shard_paths(root, len(shard_sizes))
        off = np.concatenate(
            [np.zeros(1, np.int64),
             np.cumsum([len(y) for y in pending_y], dtype=np.int64)])
        _atomic_save(px, np.concatenate(pending_x))
        _atomic_save(py, np.concatenate(pending_y).astype(np.int64))
        _atomic_save(poff, off)
        shard_sizes.append(len(pending_x))
        pending_x.clear()
        pending_y.clear()

    for c in clients:
        pending_x.append(np.asarray(c.x))
        pending_y.append(np.asarray(c.y))
        if len(pending_x) == shard_size:
            flush()
    flush()
    if not shard_sizes:
        raise ValueError("write_population_shards: empty client stream")
    meta = {"n_clients": int(sum(shard_sizes)), "shard_sizes": shard_sizes}
    tmp = os.path.join(root, _META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(root, _META_NAME))
    return meta


class DiskShardSource:
    """Out-of-core population: clients sliced from memory-mapped shards.

    ``np.load(mmap_mode="r")`` leaves a shard's bytes on disk until a
    client's rows are touched; an LRU of ``max_open`` open shard handles
    bounds the file descriptors however the sampler hops between shards.
    ``client()`` copies the client's rows out of the map, so no returned
    ``ClientData`` holds a shard file open.
    """

    def __init__(self, root: str, max_open: int = 8):
        meta_path = os.path.join(root, _META_NAME)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"no {_META_NAME} under {root!r}: write the population "
                f"with repro_torch.population.write_population_shards first")
        with open(meta_path) as f:
            meta = json.load(f)
        self.root = root
        self.n_clients = int(meta["n_clients"])
        self.shard_sizes = np.asarray(meta["shard_sizes"], np.int64)
        self.starts = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(self.shard_sizes)])
        self.max_open = max_open
        self._open: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()
        self.shard_opens = 0        # cold-tier file opens (telemetry)

    def _shard(self, s: int) -> tuple:
        handle = self._open.get(s)
        if handle is not None:
            self._open.move_to_end(s)
            return handle
        px, py, poff = _shard_paths(self.root, s)
        handle = (np.load(px, mmap_mode="r"), np.load(py, mmap_mode="r"),
                  np.load(poff))
        self.shard_opens += 1
        self._open[s] = handle
        while len(self._open) > self.max_open:
            self._open.popitem(last=False)
        return handle

    def _locate(self, cid: int) -> tuple[int, int]:
        _check_cid(cid, self.n_clients)
        s = int(np.searchsorted(self.starts, cid, side="right") - 1)
        return s, cid - int(self.starts[s])

    def client_n(self, cid: int) -> int:
        s, i = self._locate(cid)
        off = self._shard(s)[2]
        return int(off[i + 1] - off[i])

    def max_client_n(self) -> int:
        """The largest client from the shards' offset tables alone (the x
        and y maps stay cold); through ``_shard``, so the handle LRU holds
        and ``shard_opens`` counts these opens."""
        best = 0
        for s in range(len(self.shard_sizes)):
            off = self._shard(s)[2]
            best = max(best, int(np.max(np.diff(off))))
        return best

    def client(self, cid: int) -> ClientData:
        s, i = self._locate(cid)
        x, y, off = self._shard(s)
        lo, hi = int(off[i]), int(off[i + 1])
        return ClientData(np.array(x[lo:hi]), np.array(y[lo:hi]))
