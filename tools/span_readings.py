#!/usr/bin/env python3
"""One run of a benchmark cell with the port's spans kept in memory.

    python3 tools/span_readings.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Runs ``cardbench.harness.run_cell`` as ``cardbench/run.py`` does, with
``repro_torch.trace`` enabled around the entry's drive.  ``--trace 0``
prints the result line alone: the run's round time with spans kept, for
the cost of keeping them.  ``--trace 1`` also lays the kept spans and the
two profiles against each other (``cardbench.spans.digest``) and prints a
second JSON line: the device ms a host-profiled round put down to each
layer of the step and to the teacher (by the kernel's launch, on any
thread), the device-only round's idle ms under the step and under the
round's data, the span counts, the host-profiled rounds' busy ms, the
median gap between the kept spans and their profiler ranges, and the
paths the device and idle time fell to.

The benchmark itself reads only what its harness gives its readers; this
wires in what ``cardbench/spans.py``'s ``device_ms`` and ``idle_ms`` read.
Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def wire(cell, captured: dict) -> None:
    """Keep the spans around the entry's drive; stamp the device-only
    round's start on the spans' clock; digest the spans with the
    profiles before the harness drops them."""
    from cardbench import harness, spans
    from repro_torch import trace

    entry = cell.entry
    real_drive = entry.drive
    real_start = harness.Run._start_profile
    real_digest = harness.Run.digest_profile

    def drive(run, state):
        trace.enable()
        try:
            real_drive(run, state)
        finally:
            trace.disable()
            run.kept = trace.drain()

    def start(self, host):
        real_start(self, host)
        if not host:
            self.lo_ns = time.time_ns()

    def digest(self, ranges, ops):
        extra = {}
        if self._device_prof is not None:
            host = self._host_prof[0] if self._host_prof else None
            extra = spans.digest(self.kept, self._device_prof[0], self.lo_ns,
                                 self._device_prof[1], host)
        real_digest(self, ranges, ops)
        if self.profile is not None:
            self.profile.update(extra)
        captured["run"] = self

    entry.drive = drive
    harness.Run._start_profile = start
    harness.Run.digest_profile = digest


def readings(run) -> dict:
    from cardbench import spans

    p = run.profile
    rounds = run.profile_rounds
    idle_s = p["wall_s"] - p["busy_s"]
    out = {
        "forward_ms": spans.device_ms(run, "step_forward", "step"),
        "backward_ms": spans.device_ms(run, "step_backward", "step"),
        "optimizer_ms": spans.device_ms(run, "step_optimizer", "step"),
        "teacher_ms": spans.device_ms(run, "teacher", "teacher"),
        "step_idle_ms": spans.idle_ms(run, "step"),
        "data_idle_ms": spans.idle_ms(run, "data"),
        "expected_a_round": spans.per_round(run),
        "span_counts": p.get("span_counts"),
        "span_idle_counts": p.get("span_idle_counts"),
        "host_busy_ms_a_round": p.get("host_busy_s", 0.0) / rounds * 1e3,
        "device_round_idle_ms": idle_s * 1e3,
        "device_round_wall_ms": p["wall_s"] * 1e3,
        "clock_gap_ms": p.get("clock_gap_ms"),
        "device_ms_by_path": {"/".join(k) or "(none)": v / rounds * 1e3
                              for k, v in p.get("span_device_s", {}).items()},
        "idle_ms_by_path": {"/".join(k) or "(none)": v * 1e3
                            for k, v in p.get("span_idle_s", {}).items()},
    }
    if "grouped_conv_dw" in p["ranges"]:
        out["grouped_conv_dw_ms"] = (p["ranges"]["grouped_conv_dw"][0]
                                     / rounds * 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from cardbench import harness

    if not torch.cuda.is_available():
        print("span_readings: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    captured: dict = {}
    wire(cell, captured)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    print(json.dumps(result), flush=True)
    if args.trace:
        print(json.dumps({"spans": readings(captured["run"])}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
