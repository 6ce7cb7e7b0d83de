"""Dry-run CLI: trace the train, prefill and serve steps of every
(architecture × input shape) on the meta device and print what one H100
would take for each.

The port of ``repro.launch.dryrun``.  It allocates nothing on any device
and needs no card: each step runs eagerly on meta tensors at the
published width and full depth (``launch.dryrun_lib``), its FLOPs, bytes,
launches and peak memory counted, its roofline terms taken at the H100's
peaks (``launch.roofline``).  Every figure is a prediction computed on
meta, not a time.  Examples:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out results/dryrun_h100.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch deepseek-v3-671b --shape train_4k --kd cached_topk

The reference's ``--mesh``, ``--fsdp`` and ``--probe`` have no
counterpart: one card has no mesh and shards nothing, and an eager trace
runs every layer, so its counts need no depth probes.  Exits 1 if a run
fails for another reason than the reference's SKIP.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    from repro_torch.configs import ALL_ARCHS, SHAPES
    from repro_torch.launch import dryrun_lib

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch × shape)")
    ap.add_argument("--kd", choices=("none", "teacher", "cached_topk"),
                    default="teacher",
                    help="train-step KD mode (teacher = paper-faithful)")
    ap.add_argument("--out", default=None, help="append JSON lines here")
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    results = []
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            r = dryrun_lib.run_dryrun(arch, shape, kd_mode=args.kd)
            print(dryrun_lib.result_line(r), flush=True)
            if r.memory:
                print(f"    memory: {r.memory}", flush=True)
            results.append(r.to_json())
            if not r.ok and not r.error.startswith("SKIP"):
                n_fail += 1

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    print(f"\n{len(results)} runs, {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
