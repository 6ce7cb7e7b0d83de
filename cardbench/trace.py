"""What a traced run reads from ``torch.profiler``: from a round traced
with the device's activity alone, the device's busy time and its time by
kernel; from rounds traced with the host's events too, the device time
inside named ranges and operators (with the operators' input shapes) and
the idle gaps labelled by what the host was doing.

Device activity is the union of the intervals of the kernels and copies
on the device's timeline (the ranges the profiler mirrors there are left
out); an idle gap is a stretch between two such intervals, labelled by the
innermost host event open at its middle.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

TOP = 10


def _device_spans(events) -> list:
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def _merge(spans: list) -> list:
    merged = []
    for lo, hi, _ in spans:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def _label_gaps(gaps: list, host: list) -> list:
    """[(seconds, label)] for ``gaps`` [(lo, hi)], each labelled by the
    latest-starting host event that contains its middle."""
    host = sorted(host)                       # (start, end, name)
    starts = [h[0] for h in host]
    out, active, i = [], [], 0
    for lo, hi in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (lo + hi) / 2
        j = bisect.bisect_right(starts, mid)
        active.extend(host[i:j])
        i = max(i, j)
        while active and active[-1][1] < mid:
            active.pop()
        out.append(((hi - lo) / 1e6, active[-1][2] if active else "(none)"))
    return out


def device_digest(prof, wall_s: float) -> dict:
    """A window traced with the device's activity alone (the host's events
    are not recorded, so the host runs at its own pace): ``busy_s``,
    ``wall_s`` and ``kernels`` {name: seconds}."""
    spans = _device_spans(prof.events())
    busy_us = sum(hi - lo for lo, hi in _merge(spans))
    kernels: dict = defaultdict(float)
    for lo, hi, name in spans:
        kernels[name] += (hi - lo) / 1e6
    return {"busy_s": busy_us / 1e6, "wall_s": wall_s,
            "kernels": dict(kernels)}


def host_digest(prof, ranges: tuple = (), ops: tuple = ()) -> dict:
    """A window traced with the host's events and their shapes: ``ranges``
    {name: (device seconds, hits)}, ``ops`` {name: [(input shapes,
    concrete inputs, device seconds)]}, ``idle_gaps`` [(label, seconds)]
    summed by label, longest first (the host runs slower under this
    tracing, so the gaps are longer than in a run without it)."""
    events = prof.events()
    merged = _merge(_device_spans(events))
    out_ranges = {r: [0.0, 0] for r in ranges}
    out_ops: dict = {o: [] for o in ops}
    host = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        host.append((e.time_range.start, e.time_range.end, e.name))
        if e.name in out_ranges:
            out_ranges[e.name][0] += e.device_time_total / 1e6
            out_ranges[e.name][1] += 1
        elif e.name in out_ops:
            out_ops[e.name].append((e.input_shapes,
                                    getattr(e, "concrete_inputs", None),
                                    e.device_time_total / 1e6))
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    by_label: dict = defaultdict(float)
    for sec, label in _label_gaps(gaps, host):
        by_label[label] += sec
    return {"ranges": {k: tuple(v) for k, v in out_ranges.items()},
            "ops": out_ops,
            "idle_gaps": sorted(by_label.items(), key=lambda kv: -kv[1])}


def breakdown(d: dict) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the idle gaps by what the host was doing, ten each."""
    ops = sorted(d["kernels"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n[:120], s] for n, s in d["idle_gaps"][:TOP]]}
