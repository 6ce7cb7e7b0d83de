"""The port's spans (``repro_torch.trace``) in a traced run: what they
count, the device time each one launched and the device's idle time under
each.

A span is ``(name, start_ns, end_ns, parent, thread)``, ``parent`` the
index of the innermost span open on the same thread (-1 for none), the
times on the clock the profiler places its events on.  The port keeps
such spans in memory while ``repro_torch.trace`` is enabled; in a trace
with the host's events each span is also a range of its name, from which
``profile_spans`` makes the same tuples.

The spans of one step run on two threads: the autograd engine runs a CUDA
backward on a device thread of its own, where the kernels' gradient
ranges (``grouped_conv_dw``, ``grouped_conv_dx``) open while the main
thread waits inside ``step_backward``.  So a span on another thread than
the run's first span, with no parent of its own, is taken as a child of
the innermost span of that first thread open at its start (``adopt``),
and a kernel launched on a thread with no span open is put down to that
first thread (``device_by_span``).

Pure functions over plain lists (``nest``, ``adopt``, ``device_by_span``,
``idle_by_span``, ``by_path``), the adapters over ``torch.profiler``
(``profile_spans``, ``launches``, ``device_intervals``), ``digest``, which
reads a traced run's two profiles and the port's kept spans, and the
readers of what the spans measure.  ``range_s`` reads the device time of a
span's ranges as the harness totals it (``trace.host_digest``'s
``ranges``: what was launched on the range's own thread); the metrics
``forward_ms``, ``optimizer_ms`` and ``teacher_ms`` read it.  The harness
neither keeps the port's spans nor calls ``digest``, so ``device_ms`` and
``idle_ms`` read nothing in its runs: ``tools/span_readings.py`` runs a
cell with both wired in.
"""
from __future__ import annotations

import statistics
from collections import Counter, defaultdict

import torch

# the spans whose device time and idle time the readers sum, by the path of
# these names from a span up to its outermost ancestor
LAYERS = ("data", "teacher", "step", "step_forward", "step_backward",
          "step_optimizer")
# every span the port names: the layers and the kernels' gradient ranges
NAMES = LAYERS + ("grouped_conv_dw", "grouped_conv_dx", "ssd_scan_backward")
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


# -- pure functions ---------------------------------------------------------

def nest(ranges: list) -> list:
    """Spans from ``[(name, start_ns, end_ns, thread)]``, sorted by start
    (the outer of two that start together first), each with the innermost
    range of its thread that holds it as parent."""
    ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))
    out, open_by_thread = [], defaultdict(list)
    for i, (name, start, end, thread) in enumerate(ranges):
        stack = open_by_thread[thread]
        while stack and ranges[stack[-1]][2] < start:
            stack.pop()
        out.append((name, start, end, stack[-1] if stack else -1, thread))
        stack.append(i)
    return out


def _main_thread(spans: list):
    return min(spans, key=lambda s: s[1])[4] if spans else None


def _innermost(spans: list, candidates: list, times: list) -> list:
    """For each of ``times``, the index of the latest-starting span of
    ``candidates`` (indices of spans of one thread, so nested) open at
    it, or -1."""
    cand = sorted(candidates, key=lambda i: spans[i][1])
    out, stack, j = [-1] * len(times), [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(cand) and spans[cand[j]][1] <= t:
            while stack and spans[stack[-1]][2] < spans[cand[j]][1]:
                stack.pop()
            stack.append(cand[j])
            j += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


def _by_thread(spans: list) -> dict:
    out = defaultdict(list)
    for i, s in enumerate(spans):
        out[s[4]].append(i)
    return out


def adopt(spans: list) -> list:
    """Each span's parent: its own, or for a span with none on another
    thread than the first span's, the innermost span of that first thread
    open at its start (-1 where there is none)."""
    main = _main_thread(spans)
    parents = [s[3] for s in spans]
    orphans = [i for i, s in enumerate(spans) if s[3] < 0 and s[4] != main]
    found = _innermost(spans, _by_thread(spans)[main],
                       [spans[i][1] for i in orphans])
    for i, p in zip(orphans, found):
        parents[i] = p
    return parents


def device_by_span(activities: list, spans: list) -> dict:
    """Device ns summed by span index (-1: none) over ``activities``
    ``[(start_ns, end_ns, thread, launch_ns)]``, each put down to the
    innermost span open on its launching thread when it was launched, or
    where that thread has none open, on the first span's thread."""
    threads = _by_thread(spans)
    owner = [-1] * len(activities)
    queries = defaultdict(list)
    for k, a in enumerate(activities):
        queries[a[2]].append(k)
    for thread, ks in queries.items():
        for k, i in zip(ks, _innermost(spans, threads.get(thread, []),
                                       [activities[k][3] for k in ks])):
            owner[k] = i
    rest = [k for k in range(len(activities)) if owner[k] < 0]
    for k, i in zip(rest, _innermost(spans, threads.get(_main_thread(spans),
                                                        []),
                                     [activities[k][3] for k in rest])):
        owner[k] = i
    out: dict = defaultdict(int)
    for k, (start, end, _, _) in enumerate(activities):
        out[owner[k]] += end - start
    return dict(out)


def idle_gaps(intervals: list, lo: int, hi: int) -> list:
    """The stretches of ``[lo, hi]`` that no interval ``(start, end)``
    covers, the edges before the first and after the last included."""
    gaps, cur = [], lo
    for start, end in sorted(intervals):
        if end <= lo or start >= hi:
            continue
        start, end = max(start, lo), min(end, hi)
        if start > cur:
            gaps.append((cur, start))
        cur = max(cur, end)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


def idle_by_span(intervals: list, spans: list, lo: int, hi: int) -> dict:
    """The device's idle ns in ``[lo, hi]`` (``idle_gaps``) summed by the
    index of the innermost span, of any thread, open at each gap's middle
    (-1: none)."""
    gaps = idle_gaps(intervals, lo, hi)
    mids = [(a + b) // 2 for a, b in gaps]
    best = [-1] * len(gaps)
    for cand in _by_thread(spans).values():
        for q, i in enumerate(_innermost(spans, cand, mids)):
            if i >= 0 and (best[q] < 0 or spans[i][1] > spans[best[q]][1]):
                best[q] = i
    out: dict = defaultdict(int)
    for (a, b), i in zip(gaps, best):
        out[i] += b - a
    return dict(out)


def by_path(spans: list, parents: list, values: dict,
            names=LAYERS) -> dict:
    """``values`` {span index: number} summed by the span's path: the
    names among ``names`` of the span and its ancestors, outermost first
    (index -1 and a span with none of them: ``()``)."""
    memo: dict = {-1: ()}

    def path(i):
        if i not in memo:
            up = path(parents[i])
            memo[i] = up + (spans[i][0],) if spans[i][0] in names else up
        return memo[i]

    out: dict = defaultdict(float)
    for i, v in values.items():
        out[path(i)] += v
    return dict(out)


# -- adapters over torch.profiler --------------------------------------------

def _events(prof):
    return prof.profiler.kineto_results.events()


def _is_device(e) -> bool:
    return e.device_type() == CUDA and not e.is_user_annotation()


def profile_spans(prof, names=NAMES) -> list:
    """The host ranges named ``names`` of a trace with the host's events,
    as spans (``nest``)."""
    return nest([(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
                 for e in _events(prof)
                 if e.device_type() == CPU and e.name() in names])


def launches(prof) -> list:
    """Each kernel and copy of a trace with the host's events as
    ``(start_ns, end_ns, thread, launch_ns)``: the thread and start of the
    host operation or range it was launched in (linked by correlation id);
    one with no such link is taken as launched on no span's thread at its
    own start.  A host event that links to none is an operation or a
    range, or the profiler's own work under the id of the operation it
    interrupted, which starts later: the first event of an id is kept."""
    events = _events(prof)
    host: dict = {}
    for e in sorted((e for e in events if e.device_type() == CPU
                     and e.linked_correlation_id() == 0),
                    key=lambda e: e.start_ns()):
        host.setdefault(e.correlation_id(), (e.start_thread_id(),
                                             e.start_ns()))
    out = []
    for e in events:
        if _is_device(e):
            link = e.linked_correlation_id()
            thread, at = (host.get(link, (None, e.start_ns())) if link
                          else (None, e.start_ns()))
            out.append((e.start_ns(), e.end_ns(), thread, at))
    return out


def device_intervals(prof) -> list:
    """The kernels' and copies' ``(start_ns, end_ns)`` in a trace."""
    return [(e.start_ns(), e.end_ns()) for e in _events(prof)
            if _is_device(e)]


def _union_ns(intervals: list) -> int:
    total, cur = 0, None
    for start, end in sorted(intervals):
        if cur is None or start > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    return total + (cur[1] - cur[0] if cur else 0)


def clock_gaps(kept: list, ranges: list) -> list:
    """|start| and |end| differences in ns between each kept span and the
    range of its name in the same place among that name's ranges (both in
    order of start), over the ranges' stretch of time."""
    lo = min((r[1] for r in ranges), default=0)
    hi = max((r[2] for r in ranges), default=0)
    mine, theirs = defaultdict(list), defaultdict(list)
    for s in kept:
        if lo <= s[1] <= hi:
            mine[s[0]].append(s)
    for r in ranges:
        theirs[r[0]].append(r)
    out = []
    for name, rs in theirs.items():
        for a, b in zip(sorted(mine[name], key=lambda s: s[1]),
                        sorted(rs, key=lambda s: s[1])):
            out += [abs(a[1] - b[1]), abs(a[2] - b[2])]
    return out


def digest(kept: list, device_prof, lo_ns: int, wall_s: float,
           host_prof) -> dict:
    """What the spans read in a traced run, under keys of the harness's
    ``profile``: from the host-profiled rounds' ranges, ``span_device_s``
    (device seconds by path, ``by_path``), ``span_counts`` and
    ``host_busy_s``; from the device-only round, laid against the port's
    ``kept`` spans on the shared clock, ``span_idle_s`` (idle seconds by
    path in ``[lo_ns, lo_ns + wall_s]``) and ``span_idle_counts``; and
    ``clock_gap_ms``, the median of ``clock_gaps`` over the host rounds."""
    out: dict = {}
    if host_prof is not None:
        ranges = profile_spans(host_prof)
        dev = device_by_span(launches(host_prof), ranges)
        out["span_device_s"] = {p: v / 1e9 for p, v in by_path(
            ranges, adopt(ranges), dev).items()}
        out["span_counts"] = dict(Counter(r[0] for r in ranges))
        out["host_busy_s"] = _union_ns(device_intervals(host_prof)) / 1e9
        gaps = clock_gaps(kept, ranges)
        out["clock_gap_ms"] = statistics.median(gaps) / 1e6 if gaps else None
    if device_prof is not None and kept:
        hi_ns = lo_ns + int(wall_s * 1e9)
        idle = idle_by_span(device_intervals(device_prof), kept, lo_ns, hi_ns)
        out["span_idle_s"] = {p: v / 1e9 for p, v in by_path(
            kept, adopt(kept), idle).items()}
        out["span_idle_counts"] = dict(Counter(
            s[0] for s in kept if lo_ns <= s[1] < hi_ns))
    return out


# -- readers ----------------------------------------------------------------

def per_round(run) -> dict:
    """The spans a round of the cell opens, by name: on ``run_federated``'s
    client-batched body a step a batch index (every client of the cohort in
    one), FedGKD's teacher once over the cohort and two of data; on
    ``run_serial`` a step a client's batch, a teacher forward inside each,
    and the round's token batches and each batch's upload."""
    tr = run.traffic
    if run.cell.workload["entry"] == "fl_loop":
        return {"step": tr["max_batches_per_client"], "teacher": 1,
                "data": 2}
    steps = tr["clients"] * tr["batches_per_round"]
    return {"step": steps, "teacher": steps, "data": 1 + steps}


def teacher_in_step(run) -> bool:
    """Whether the teacher forward runs inside the step's forward."""
    return run.cell.workload["entry"] == "run_serial"


def _counted(run, counts: dict, name: str, as_: str, rounds: int) -> bool:
    return counts.get(name, 0) == per_round(run)[as_] * rounds


def range_s(run, name: str, as_: str):
    """Device seconds of the host-profiled rounds' ranges ``name`` as the
    harness totals them, or None where their count is not ``as_``'s a
    round."""
    p = run.profile
    if p is None or name not in p["ranges"]:
        return None
    seconds, hits = p["ranges"][name]
    if not _counted(run, {name: hits}, name, as_, run.profile_rounds):
        return None
    return seconds


def device_ms(run, layer: str, as_: str):
    """Device ms a host-profiled round put down to spans whose innermost
    layer is ``layer`` (``span_device_s``), or None where the rounds'
    count of ``layer`` is not ``as_``'s."""
    p = run.profile
    if p is None or "span_device_s" not in p or not _counted(
            run, p["span_counts"], layer, as_, run.profile_rounds):
        return None
    return sum(v for path, v in p["span_device_s"].items()
               if path and path[-1] == layer) / run.profile_rounds * 1e3


def idle_ms(run, layer: str):
    """Idle ms of the device-only round put down to ``layer`` or a span
    beneath it (``span_idle_s``), or None where the round's count of
    ``layer`` is not the traffic's."""
    p = run.profile
    if p is None or "span_idle_s" not in p or not _counted(
            run, p["span_idle_counts"], layer, layer, 1):
        return None
    return sum(v for path, v in p["span_idle_s"].items()
               if layer in path) * 1e3
