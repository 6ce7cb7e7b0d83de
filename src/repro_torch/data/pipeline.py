"""Federated data: per-client shards held on the host as numpy arrays.

The port's counterpart of ``repro.data.pipeline`` for the single-device
path.  Shards stay numpy on the host; the executor uploads each round's
stacked batches to the device.  ``sample_cohort`` consumes the numpy
generator exactly as the reference does, so one seed samples the same
cohorts in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

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
