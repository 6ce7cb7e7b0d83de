"""Operation statistics of one traced step: the counterpart of
``repro.launch.hlo_stats``.

The reference parses the compiled program's HLO text.  The port has no
compiled program: an eager step is the sequence of operators it
dispatches, so ``OpStats``, a ``TorchDispatchMode``, records them as the
step runs, on the meta device (the dry-run) or on real tensors alike:

- ``op_histogram(top)``: calls per operator, aten's and the kernels'
  (``repro_torch.*``), as the reference's opcode histogram;
- ``launches``: operators that run a device kernel, which for the eager
  port is the count of launches (views and bare allocations launch
  nothing; a kernel's operator counts one);
- ``bytes_accessed``: each launch's tensor inputs read and outputs written
  once; a kernel operator's bytes from its cost function
  (``roofline.kernel_cost``), so no kernel is counted by its plain
  version's intermediates;
- ``largest``: the largest storage the step made, with its operator;
- ``peak_bytes``: the most bytes the storages created during the step
  held at once, each storage counted once (views and in-place results add
  nothing) at the size the CUDA caching allocator gives it (rounded up to
  ``ALLOC_GRANULE``), a kernel's scratch added for the duration of its
  launch.  The arguments' storages (``arguments=``) are not counted: the
  peak is the step's memory beyond them.

A storage's end is seen through a weak reference to it, so the count
follows Python's own frees, the autograd graph's included.
``collective_stats`` is the reference's on one card: empty.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import roofline
from repro_torch.tree import tree_leaves

# the CUDA caching allocator's block granularity: a request is rounded up
# to a multiple of 512 bytes
ALLOC_GRANULE = 512
# operators that only allocate: no kernel runs
_ALLOCATIONS = {"aten.empty", "aten.empty_like", "aten.empty_strided",
                "aten.new_empty", "aten.new_empty_strided"}


@dataclasses.dataclass
class CollectiveStats:
    """The reference's collective statistics; empty on one card."""
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def summary(self) -> str:
        parts = [f"{k}: n={self.count_by_kind[k]} bytes={v:,}"
                 for k, v in sorted(self.bytes_by_kind.items())]
        return "; ".join(parts) if parts else "none"


def collective_stats() -> CollectiveStats:
    """No collective: one card, one program."""
    return CollectiveStats({}, {})


def allocated_bytes(nbytes: int) -> int:
    """The bytes the CUDA caching allocator counts for a request."""
    return -(-nbytes // ALLOC_GRANULE) * ALLOC_GRANULE


def _is_view(func) -> bool:
    """Whether every result of ``func`` aliases an input without writing
    it (a view: no kernel, no new storage)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpStats(TorchDispatchMode):
    """Record the operators of the code run under it (see the module's
    docstring).  ``arguments`` is a tree of the step's inputs, whose
    storages the peak does not count."""

    def __init__(self, arguments=()):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()
        self.launches = 0
        self.bytes_accessed = 0.0
        self.live = 0
        self.peak_bytes = 0
        self._storages: dict[int, int] = {}     # storage -> bytes counted
        self._largest = (0, "")                 # the largest new storage
        for t in tree_leaves(arguments):
            if isinstance(t, torch.Tensor):
                self._track(t.untyped_storage(), 0)

    def _track(self, storage, nbytes: int) -> None:
        key = storage._cdata
        self._storages[key] = nbytes
        self.live += nbytes
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        name = str(packet)
        self.counts[name] += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            storage = t.untyped_storage()
            if storage._cdata not in self._storages:
                nbytes = allocated_bytes(storage.nbytes())
                self._track(storage, nbytes)
                if nbytes > self._largest[0]:
                    self._largest = (nbytes, f"{name}{tuple(t.shape)} "
                                             f"{str(t.dtype)[6:]}")
        scratch = 0
        if not (_is_view(func) or name in _ALLOCATIONS or not outs):
            self.launches += 1
            cost = roofline.kernel_cost(packet, args, out)
            if cost is None:
                ins = [t for t in tree_leaves((args, kwargs))
                       if isinstance(t, torch.Tensor)]
                self.bytes_accessed += sum(map(_nbytes, ins + outs))
            else:
                self.bytes_accessed += cost.nbytes
                scratch = int(cost.scratch)
        self.peak_bytes = max(self.peak_bytes, self.live + scratch)
        return out

    @property
    def largest(self) -> str:
        """The largest storage the step made: its operator, shape, dtype
        and GiB."""
        nbytes, what = self._largest
        return f"{what} {nbytes / 2 ** 30:.2f} GiB" if nbytes else "none"

    def op_histogram(self, top: int = 20) -> list[tuple[str, int]]:
        """Operator frequency, most called first (the reference's
        ``op_histogram`` over the HLO's opcodes)."""
        return sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))[:top]
