"""One run of one cell: set-up, the measured window, the traced readings,
the reference, and the result line.

The window: the entry calls the port's entry point once with more rounds
than the window can hold; the port calls ``Run.on_round`` from its round
callback after each round's ``synchronize()``.  The first ``warmup``
rounds are set-up (they build and load the kernels, reach the steady
buffer and are the rounds the reference follows); the window runs from
the end of the last warm-up round to the end of the round in which
``--seconds`` have passed, and ends the port's call by raising
``StopWindow`` out of the callback.

A traced run (``--trace 1``) traces the window's first round with the
device's activity alone (``torch.profiler``: the busy and idle time with
the host at its own pace), the ``profile_rounds`` rounds after it with
the host's events and shapes too (the spans as named ranges), and times
the spans with the device synchronised around them in the rounds after
those, which also give ``mfu``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Optional

import torch

from cardbench import trace as trace_lib
from cardbench.reference import compare

HERE = Path(__file__).resolve().parent
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "chip_smoke", "tools",
             "benchmarks")


class StopWindow(Exception):
    """Raised out of the port's round callback when the window is over."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file of its own (entries and metrics are found by
    name; a metric's name may hold dots)."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


@dataclasses.dataclass
class Cell:
    """A cell as the files describe it."""
    name: str
    workload: dict       # workloads/<cell>.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    end_to_end: list     # BENCHMARK.json's metrics this cell reports
    per_layer: list
    chips: int = 1
    root: Path = HERE

    @property
    def entry(self):
        return load_module(self.root / "entries" / f"{self.workload['entry']}.py",
                           f"cardbench_entry_{self.workload['entry']}")

    def metric(self, name: str):
        return load_module(self.root / "metrics" / f"{name}.py",
                           f"cardbench_metric_{name.replace('.', '_')}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = HERE) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` beside ``root`` with its
    files."""
    bench = load_json(root.parent / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = entries[0]
    workload = load_json(root / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != w[key]:
            raise ValueError(f"{name}: workloads/{name}.json names {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{w[key]!r}")
    return Cell(name, workload,
                load_json(root / "configs" / f"{w['config']}.json"),
                load_json(root / "traffic" / f"{w['traffic']}.json"),
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)],
                int(w["chips"]), root)


# ---------------------------------------------------------------------------

class Run:
    """The state of one run, shared by the harness, the entry and the
    metric readers."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device, self.t_start = trace, device, t_start
        self.config, self.traffic = cell.config, cell.traffic
        self.warmup = int(cell.workload["warmup_rounds"])
        self.compared = int(cell.workload["compared_rounds"])
        self.profile_rounds = (int(cell.workload["profile_rounds"])
                               if trace else 0)
        self.rounds_done = 0           # rounds the port has finished
        self.window_rounds = 0
        self.t_window = self.t_end = None
        self.readings: dict = defaultdict(list)   # the port's, see compare
        self.span_s: dict = defaultdict(float)
        self.span_rounds = 0
        # model FLOPs of round t (the entry sets it), summed over the
        # rounds the spans time
        self.round_flops = lambda t: 0.0
        self.span_flops = 0.0
        self.unprofiled_s = 0.0
        self.profile: Optional[dict] = None
        self.peak_bytes = 0
        self._prof = None
        self._stage = None              # what the round under way traces
        self._device_prof = self._host_prof = None
        self._t_unprofiled = None
        self._patches: list = []
        self.log = lambda msg: print(msg, file=sys.stderr, flush=True)

    # -- what the entry asks ------------------------------------------------
    @property
    def round(self) -> int:
        """The round the port is in (1-based)."""
        return self.rounds_done + 1

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A named range under the profiler; in the traced run's rounds
        after it, host seconds with the device synchronised around the
        call; nothing otherwise."""
        if self._stage == "host":
            with torch.profiler.record_function(name):
                yield
        elif self._stage == "spans":
            self.sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.sync()
                self.span_s[name] += time.perf_counter() - t0
        else:
            yield

    def patch(self, owner: Any, attr: str, make) -> None:
        """Replace ``owner.attr`` by ``make(original)`` for this run.  A
        target that is gone fails the run: a span must never read 0."""
        if not hasattr(owner, attr):
            raise AttributeError(f"{getattr(owner, '__name__', owner)!r} has "
                                 f"no {attr!r}: the benchmark's hook has no "
                                 f"target")
        had = attr in vars(owner) if hasattr(owner, "__dict__") else True
        original = getattr(owner, attr)
        self._patches.append((owner, attr, original, had))
        setattr(owner, attr, make(original))

    def unpatch(self) -> None:
        while self._patches:
            owner, attr, original, had = self._patches.pop()
            if had:
                setattr(owner, attr, original)
            else:
                delattr(owner, attr)

    # -- the window ---------------------------------------------------------
    def on_round(self, t: int) -> None:
        """The port's round callback, after round ``t``'s synchronize."""
        self.rounds_done = t
        now = time.perf_counter()
        if t < self.warmup:
            self.log(f"warm-up round {t}: {now - self.t_start:.4f} s since "
                     f"the process started")
            return
        if t == self.warmup:
            self.sync()
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            if self.trace:
                self._start_profile(host=False)
            self.t_window = time.perf_counter()
            return
        self.window_rounds += 1
        self.log(f"round {t}: window {now - self.t_window:.4f} s")
        over = now - self.t_window >= self.seconds
        if self._stage == "device":
            self._device_prof = self._stop_profile(now)
            if not over:
                self._start_profile(host=True)
        elif self._stage == "host":
            if self.window_rounds == 1 + self.profile_rounds or over:
                self._host_prof = self._stop_profile(now)
                self._t_unprofiled = time.perf_counter()
        elif self._stage == "spans":
            self.span_rounds += 1
            self.span_flops += self.round_flops(t)
        if over:
            self.t_end = now
            if self.span_rounds:
                self.unprofiled_s = now - self._t_unprofiled
            if self.device.type == "cuda":
                self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
            raise StopWindow

    def _start_profile(self, host: bool) -> None:
        """The window's first round is traced with the device's activity
        alone (its busy and idle time); the ``profile_rounds`` after it
        with the host's events and shapes too."""
        acts = []
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        if host or not acts:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self._prof = torch.profiler.profile(activities=acts,
                                            record_shapes=host)
        self._prof.start()
        self._stage = "host" if host else "device"
        self._t_prof = time.perf_counter()

    def _stop_profile(self, now: float):
        prof, self._prof = self._prof, None
        prof.stop()
        self._stage = "spans"
        return prof, now - self._t_prof

    def digest_profile(self, ranges: tuple, ops: tuple) -> None:
        """``profile``: the device round's busy time and kernels, the host
        rounds' ranges, operators and idle gaps (``trace``)."""
        if self._device_prof is None:
            return
        prof, wall = self._device_prof
        self.profile = trace_lib.device_digest(prof, wall)
        if self._host_prof is not None:
            self.profile.update(trace_lib.host_digest(self._host_prof[0],
                                                      ranges, ops))
        self._device_prof = self._host_prof = None


# ---------------------------------------------------------------------------

def check_layout(layout: dict, port_tree: dict) -> None:
    """The benchmark's parameter layout must be the port's, leaf for leaf
    (the port's own init on the meta device gives its layout)."""
    from cardbench.frozen import layouts

    mine = [(p, tuple(l.shape), l.dtype) for p, l in layouts.paths(layout)]
    theirs = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
              for p, t in layouts.paths(port_tree)]
    if mine != theirs:
        raise ValueError(f"the port's parameter layout changed:\n{theirs}\n"
                         f"against the benchmark's\n{mine}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None, log=None,
             all_numbers: bool = False) -> dict:
    """Run ``cell`` once on ``device``: the result line's dict, with the
    compared numbers and their limits under ``checks`` (and with
    ``all_numbers`` every number the comparison reads, under
    ``numbers``)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    run = Run(cell, seed, seconds, trace, device,
              time.perf_counter() if t_start is None else t_start)
    run.log = log
    entry = cell.entry
    state = entry.prepare(run)
    log(f"prepared: {time.perf_counter() - run.t_start:.4f} s since the "
        f"process started")
    try:
        entry.drive(run, state)
    finally:
        run.unpatch()
    if run.t_end is None:
        raise RuntimeError("the port's run ended before the window did")
    metrics: dict = {}
    if not trace:
        values = {"round_s": (run.t_end - run.t_window) / run.window_rounds,
                  "peak_gib": run.peak_bytes / 2 ** 30,
                  "setup_s": run.t_window - run.t_start}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    readers = {m["name"]: cell.metric(m["name"]) for m in cell.per_layer}
    if trace:
        run.digest_profile(
            tuple(r for mod in readers.values()
                  for r in getattr(mod, "RANGES", ())),
            tuple(o for mod in readers.values()
                  for o in getattr(mod, "OPS", ())))
        if run.profile is not None:
            p = run.profile
            log(f"trace: busy {p['busy_s']:.4f} s of {p['wall_s']:.4f} s; "
                f"ranges {p['ranges']}; ops "
                f"{ {k: len(v) for k, v in p['ops'].items()} }")
        for m in cell.per_layer:
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    program = {k: (torch.stack([torch.as_tensor(x).cpu() for x in v])
                   if isinstance(v, list) else torch.as_tensor(v).cpu())
               for k, v in entry.program_readings(run).items()}
    _free()
    t_ref = time.perf_counter()
    ref = entry.reference(run, state)
    _free()
    log(f"reference: {time.perf_counter() - t_ref:.1f} s")
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules loaded that no run may hold: {bad}")
    numbers = compare.gaps(program, ref)
    limits = cell.workload["limits"]
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"limits for numbers no reading gives: {missing}")
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    device_rec = {"platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
                  "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    result = {"correct": bool(correct), "attempted": run.window_rounds,
              "failed": 0, "metrics": metrics, "device": device_rec}
    if trace and run.profile is not None:
        device_rec["busy_s"] = run.profile["busy_s"]
        device_rec["window_s"] = run.profile["wall_s"]
        result["breakdown"] = trace_lib.breakdown(run.profile)
    if all_numbers:
        result["numbers"] = numbers
    result["checks"] = checks
    for name in sorted(set(numbers) - set(limits)):
        log(f"reading {name}: {numbers[name]!r} (not compared)")
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    return result
