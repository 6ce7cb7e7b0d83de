"""Named spans at the port's layer boundaries.

``span(name)`` marks a stretch of host work as one layer's:

    with trace.span("step_backward"):
        grads = torch.autograd.grad(loss, leaves)

Off, and with no ``torch.profiler`` recording (the default), a span is
one flag check and one check of the profiler's state, and returns a shared
context that does nothing.  While a profiler records, each span opens a
``torch.profiler.record_function`` range of its name, so a trace shows it
on the host's timeline and totals the device time of the work launched
inside it.  Between ``enable()`` and ``disable()`` each span is also kept
in memory as ``(name, start_ns, end_ns, parent, thread)``: ``parent`` the
index of the innermost span open on the same thread (-1 for none),
``thread`` ``threading.get_ident()``.  Its times are ``time.time_ns()``,
the clock the profiler places its events on (its events' times are
``trace_start_ns()`` plus their offsets), so the spans can be laid against
the device's activity in a trace that recorded no host events.
``drain()`` returns the kept spans and clears them; call it with no span
open, since a parent is an index into the list it clears.

The spans of the two paths the benchmark runs (``core.client.make_step``,
``core.executor.VmapExecutor.run_round``, ``launch.steps``,
``launch.train``): ``data`` (host batches and their upload), ``teacher``
(FedGKD's teacher forwards), ``step`` with ``step_forward``,
``step_backward`` and ``step_optimizer`` inside it; and the kernels'
gradient ranges ``grouped_conv_dw``, ``grouped_conv_dx`` and
``ssd_scan_backward``.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

_ON = False
_SPANS: list = []              # [name, start_ns, end_ns, parent, thread]
_LOCK = threading.Lock()
_OPEN = threading.local()      # .stack: indices of this thread's open spans
_NOOP = contextlib.nullcontext()


def enable() -> None:
    """Keep every span in memory from now on."""
    global _ON
    _ON = True


def disable() -> None:
    """Stop keeping spans (those kept stay until ``drain``)."""
    global _ON
    _ON = False


def drain() -> list:
    """The kept spans, in the order they opened, as tuples ``(name,
    start_ns, end_ns, parent, thread)``; the record is emptied."""
    with _LOCK:
        out = [tuple(s) for s in _SPANS]
        _SPANS.clear()
    return out


class _Span:
    __slots__ = ("name", "keep", "range", "entry")

    def __init__(self, name: str, keep: bool, ranged: bool):
        self.name, self.keep = name, keep
        self.range = (torch.profiler.record_function(name) if ranged
                      else None)
        self.entry = None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.keep:
            stack = getattr(_OPEN, "stack", None)
            if stack is None:
                stack = _OPEN.stack = []
            entry = [self.name, 0, 0, stack[-1] if stack else -1,
                     threading.get_ident()]
            with _LOCK:
                stack.append(len(_SPANS))
                _SPANS.append(entry)
            entry[1] = time.time_ns()
            self.entry = entry
        return self

    def __exit__(self, *exc):
        if self.entry is not None:
            self.entry[2] = time.time_ns()
            _OPEN.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager naming the work inside it ``name`` (module
    docstring)."""
    if _ON:
        return _Span(name, True, torch.autograd._profiler_enabled())
    if torch.autograd._profiler_enabled():
        return _Span(name, False, True)
    return _NOOP
