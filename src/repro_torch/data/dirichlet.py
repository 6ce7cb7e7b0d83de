"""Dirichlet non-IID client partitioning (Hsu et al. 2019), as in the paper.

A numpy copy of ``repro.data.dirichlet``: the same seed gives the same
partition, byte for byte.  For each class c, a Dir(α) draw over the K
clients decides what fraction of class-c examples each client receives.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_per_client: int = 2) -> list[np.ndarray]:
    """Return per-client index arrays (disjoint cover of ``labels``)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            client_idx[k].extend(part.tolist())
    # guarantee a minimum per client (move from the largest)
    sizes = [len(ci) for ci in client_idx]
    order = np.argsort(sizes)
    for k in order:
        while len(client_idx[k]) < min_per_client:
            donor = int(np.argmax([len(ci) for ci in client_idx]))
            client_idx[k].append(client_idx[donor].pop())
    out = [np.array(sorted(ci), dtype=np.int64) for ci in client_idx]
    if sum(len(o) for o in out) != len(labels):
        raise RuntimeError("dirichlet_partition lost examples")
    return out


def partition_stats(labels: np.ndarray, parts: list[np.ndarray]) -> np.ndarray:
    """(K, C) label-count matrix — the paper's Fig.3 visualization data."""
    n_classes = int(labels.max()) + 1
    mat = np.zeros((len(parts), n_classes), dtype=np.int64)
    for k, idx in enumerate(parts):
        cls, cnt = np.unique(labels[idx], return_counts=True)
        mat[k, cls] = cnt
    return mat
