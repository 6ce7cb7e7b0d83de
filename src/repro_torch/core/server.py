"""Server side: weighted aggregation, the FedGKD global-model buffer, the
fault-tolerance gate and the async path's staleness weights.

The port of ``repro.core.server``.  ``ModelBuffer`` is the M-deep FIFO of
historical global weights (Alg. 1, line 11); FedGKD ships its fused mean as
the teacher.

``validate_update`` is the server's admission check on every client upload
when fault handling is on (``run_federated(faults=)``): non-finite
parameters and norm outliers (an update whose L2 norm exceeds
``FaultPolicy.max_norm_mult`` times the current global's) are rejected
before they reach aggregation or the teacher buffer.  ``FaultPolicy`` also
holds the quorum and the capped exponential retry backoff.

The buffered-asynchronous server aggregates B updates, each tagged with
the global version it started from (staleness = current − start);
``async_aggregation_weights`` multiplies the data weights by
``staleness_scale``: ``constant`` (1), ``polynomial`` ((1 + s)^−a) or
``fedgkd`` (polynomial, but 0 past ``cutoff``: such updates only reach
the teacher buffer, through ``Algorithm.absorb_stale``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Optional, Sequence

import torch

from repro_torch.core.distillation import ensemble_average
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_paths

STALENESS_SCHEMES = ("constant", "polynomial", "fedgkd")


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """How the server degrades under client failures.

        quorum_frac     a sync round proceeds once this fraction of the
                        cohort has produced a valid update
        max_retries     retry attempts per round (sync) or per client
                        (async redispatch) before giving up
        backoff_base    the first retry waits this many virtual seconds;
        backoff_cap     each further attempt doubles it, capped here
        max_norm_mult   ``validate_update`` rejects an update whose L2
                        norm exceeds this multiple of the global's
    """
    quorum_frac: float = 0.6
    max_retries: int = 3
    backoff_base: float = 1.0
    backoff_cap: float = 30.0
    max_norm_mult: float = 10.0

    def __post_init__(self):
        if not (0.0 < self.quorum_frac <= 1.0):
            raise ValueError(f"quorum_frac in (0, 1], got {self.quorum_frac}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    def backoff(self, attempt: int) -> float:
        """Capped exponential backoff for retry ``attempt`` (1-based)."""
        return min(self.backoff_cap,
                   self.backoff_base * (2.0 ** (attempt - 1)))


def first_nonfinite_path(tree: Any) -> Optional[str]:
    """'/'-joined path of the first leaf containing NaN/Inf, else None.
    Integer and bool leaves are always finite and skipped.  The leaves'
    flags are read back from the device once for the whole tree."""
    leaves = [(path, torch.as_tensor(leaf)) for path, leaf in tree_paths(tree)]
    leaves = [(path, t) for path, t in leaves
              if t.is_floating_point() or t.is_complex()]
    if not leaves:
        return None
    device = leaves[0][1].device
    finite = torch.stack([torch.isfinite(t).all().to(device)
                          for _, t in leaves]).tolist()
    for (path, _), ok in zip(leaves, finite):
        if not ok:
            return "/".join(str(p) for p in path)
    return None


def _global_norm(tree: Any) -> float:
    """L2 norm over every leaf, in fp32 (one read back)."""
    return float(torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                                for l in tree_leaves(tree))))


def validate_update(params: Any, ref_params: Any = None, *,
                    max_norm_mult: float = 10.0) -> tuple[bool, str]:
    """Admission check for one client upload: ``(True, "ok")`` or
    ``(False, reason)`` with reason ``"nonfinite:<leaf path>"`` or
    ``"norm:<ratio>x"``.  The norm gate compares against ``ref_params``
    (the current global) with a floor of 1.0, so a near-zero reference
    cannot reject everything."""
    bad = first_nonfinite_path(params)
    if bad is not None:
        return False, f"nonfinite:{bad}"
    if ref_params is not None and max_norm_mult is not None:
        ref = max(_global_norm(ref_params), 1.0)
        ratio = _global_norm(params) / ref
        if ratio > max_norm_mult:
            return False, f"norm:{ratio:.1f}x"
    return True, "ok"


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


def staleness_scale(staleness: float, scheme: str = "polynomial", *,
                    a: float = 0.5, cutoff: "float | None" = None) -> float:
    """Multiplier for an update that started ``staleness`` versions ago:
    non-negative, monotone non-increasing under ``polynomial``, exactly 1.0
    under ``constant``."""
    if scheme not in STALENESS_SCHEMES:
        raise ValueError(f"unknown staleness scheme {scheme!r}; "
                         f"available: {STALENESS_SCHEMES}")
    s = float(staleness)
    if s < 0.0:
        raise ValueError(f"negative staleness {s}")
    if scheme == "constant":
        return 1.0
    if scheme == "fedgkd" and cutoff is not None and s > cutoff:
        return 0.0
    return (1.0 + s) ** (-a)


def async_aggregation_weights(data_weights: Sequence[float],
                              staleness: Sequence[float],
                              scheme: str = "polynomial", *,
                              a: float = 0.5,
                              cutoff: "float | None" = None,
                              normalize: bool = True) -> list[float]:
    """Data weights times staleness multipliers; a distribution with
    ``normalize=True``, the raw products (what ``weighted_average``
    takes) otherwise.  If every update scaled to 0 (an all-stale buffer
    past the fedgkd cutoff) the data weights are used unscaled."""
    if len(data_weights) != len(staleness):
        raise ValueError("one staleness per data weight")
    raw = [float(n) * staleness_scale(s, scheme, a=a, cutoff=cutoff)
           for n, s in zip(data_weights, staleness)]
    if sum(raw) <= 0.0:
        raw = [float(n) for n in data_weights]
    if not normalize:
        return raw
    total = sum(raw)
    return [r / total for r in raw]


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
