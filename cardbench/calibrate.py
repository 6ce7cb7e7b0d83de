"""The readings the limits of ``correct`` are set from, on the card at a
cell's own size.  For each of ``--program-seeds``, the port's own numbers:
a run of the cell with a window of one round, compared with the reference
as every run compares it.  For each of ``--seeds``, the reference, and in
the port's place the control (the reference one precision below the
configuration's: TF32 for an fp32 cell, fp8 products for a bf16 cell) and
the planted faults (half of every batch left out, every reported loss
altered by 1%, every step returning its state unchanged, the KD term's
gradient dropped, the KD term left out), each compared with the reference
as a run compares the port.  The reference's own loss and KD term, a
round's mean, ride along.

    python3 cardbench/calibrate.py --workload <cell> \\
        --program-seeds 21 22 ... --seeds 11 12 13

One JSON line a seed and reading.  The benchmark's runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
FAULTS = ("half_batch", "altered_loss", "unchanged", "kd_dropped", "kd_off")


def main(argv=None, cell=None, device: str = "cuda") -> int:
    """``cell`` and ``device`` in place of the named cell and the card: a
    CPU test's small cell."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--what", nargs="+",
                    default=["control", *FAULTS])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from cardbench import harness
    from cardbench.reference import compare

    if device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = cell or harness.load_cell(args.workload)

    def emit(seed, what, gaps, seconds, **extra):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": what, "gaps": gaps,
                          "seconds": seconds, **extra}), flush=True)

    for seed in args.program_seeds:
        t0 = time.perf_counter()
        result = harness.run_cell(cell, seed, 0.0, False, device,
                                  all_numbers=True)
        emit(seed, "program", result["numbers"], time.perf_counter() - t0,
             correct=result["correct"])
        harness._free()
    entry = cell.entry
    dtype = cell.config.get("dtype", cell.config.get("activation_dtype"))
    for seed in args.seeds:
        run = harness.Run(cell, seed, 0.0, False, torch.device(device),
                          time.perf_counter())
        state = entry.prepare(run)
        t0 = time.perf_counter()
        ref = entry.reference(run, state)
        base_s = time.perf_counter() - t0
        sizes = {k: ref[k].to(torch.float64).reshape(
            ref[k].shape[0], -1).mean(1).tolist()
            for k in ("loss", "kd") if k in ref}
        emit(seed, "reference", sizes, base_s)
        for what in args.what:
            t0 = time.perf_counter()
            if what == "control":
                got = entry.reference(run, state, precision=CONTROL[dtype])
            elif what == "altered_loss":
                # the fault scales the reported losses and nothing else
                got = dict(ref, loss=ref["loss"] * 1.01)
            else:
                got = entry.reference(run, state, fault=what)
            emit(seed, what, compare.gaps(got, ref),
                 time.perf_counter() - t0, reference_seconds=base_s)
            del got
            harness._free()
        del ref, state
        harness._free()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
