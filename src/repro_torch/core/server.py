"""Server side: weighted aggregation and the FedGKD global-model buffer.

The port of the main-path parts of ``repro.core.server``.  ``ModelBuffer``
is the M-deep FIFO of historical global weights (Alg. 1, line 11); FedGKD
ships its fused mean as the teacher.
"""
from __future__ import annotations

import collections
from typing import Any, Optional

import torch

from repro_torch.core.distillation import ensemble_average
from repro_torch.tree import tree_flatten, tree_map, tree_paths


def first_nonfinite_path(tree: Any) -> Optional[str]:
    """'/'-joined path of the first leaf containing NaN/Inf, else None.
    Integer and bool leaves are always finite and skipped."""
    for path, leaf in tree_paths(tree):
        t = torch.as_tensor(leaf)
        if not (t.is_floating_point() or t.is_complex()):
            continue
        if not bool(torch.isfinite(t).all()):
            return "/".join(str(p) for p in path)
    return None


def weighted_average(params_list: list[Any], weights: list[float]) -> Any:
    """FedAvg aggregation  w ← Σ_k (n_k/n)·w_k  (Alg. 1 line 14)."""
    total = float(sum(weights))
    norm = [w / total for w in weights]

    def agg(*leaves):
        acc = norm[0] * leaves[0].to(torch.float32)
        for w, leaf in zip(norm[1:], leaves[1:]):
            acc = acc + w * leaf.to(torch.float32)
        return acc.to(leaves[0].dtype)

    first, *rest = params_list
    return tree_map(agg, first, *rest)


def _trees_identical(a: Any, b: Any) -> bool:
    """Bitwise pytree equality (structure + every element)."""
    la, _ = tree_flatten(a)
    lb, _ = tree_flatten(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y):
            return False
    return True


class ModelBuffer:
    """FIFO of the latest M global models, each with a version number.

    ``push`` raises on a non-finite candidate (a poisoned teacher would
    distill its damage into every later local step) and refuses, returning
    False, a candidate bitwise-identical to the current head.
    """

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"buffer size must be >= 1, got {size}")
        self.size = size
        self._buf: collections.deque = collections.deque(maxlen=size)
        self._versions: collections.deque = collections.deque(maxlen=size)
        self._next_version = 0

    def push(self, params: Any) -> bool:
        bad = first_nonfinite_path(params)
        if bad is not None:
            raise ValueError(
                f"ModelBuffer.push: non-finite teacher candidate at "
                f"leaf {bad!r} — rejected updates must be quarantined "
                f"before they reach the KD buffer")
        if self._buf and _trees_identical(params, self._buf[-1]):
            return False
        self._buf.append(params)
        self._versions.append(self._next_version)
        self._next_version += 1
        return True

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def models(self) -> list[Any]:
        """Newest-first list of buffered global models."""
        return list(reversed(self._buf))

    @property
    def versions(self) -> list[int]:
        """Newest-first version ids, aligned with ``models``."""
        return list(reversed(self._versions))

    def fused(self) -> Any:
        """FedGKD ensemble teacher  w̄_t = mean of buffer."""
        if not self._buf:
            raise ValueError("ModelBuffer.fused: empty buffer")
        return ensemble_average(list(self._buf))
