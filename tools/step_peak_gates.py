#!/usr/bin/env python3
"""The dry-run's step-peak predictions against the card, alone.

    python3 tools/step_peak_gates.py

Runs ``chip_smoke.step_peak_gate`` for the three cuts ``chip_smoke.py``
gates (phi4-mini-3.8b at depth 8, mixtral-8x7b at depth 2, deepseek-v3-671b
at depth 1 with one dense layer; bf16 at published width, one FedGKD step
of 2 x 1,024 tokens): each step's device memory beyond its resident
params, teacher and optimizer state against the prediction of
``launch.dryrun_lib`` traced on the meta device, with the step's wall time
beside the dry-run's bound.  Before them, ``chip_smoke.dispatch_cost``:
the host's time a call of B1 through its ``repro_torch`` operator and
through its launch function called directly.  Prints one JSON line of
the figures last; fails if a ratio leaves ``chip_smoke.STEP_PEAK_BAND``.
Needs the card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_peak_gates: no CUDA card visible", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    build.library()
    dev = torch.device("cuda", 0)
    out = {"dispatch_us": cs.dispatch_cost(dev), "gates": []}
    for arch, layers, dense in (("phi4-mini-3.8b", cs.BF16_PHI_LAYERS, None),
                                (cs.MOE_ARCH, cs.MOE_TRAIN_LAYERS, None),
                                (cs.DS_ARCH, cs.DS_TRAIN_LAYERS,
                                 cs.DS_TRAIN_LAYERS)):
        cfg = cs.bf16_config(arch, layers)
        if dense is not None:
            cfg = cfg.replace(first_k_dense=dense)
        out["gates"].append(cs.step_peak_gate(f"{arch} d{layers} bf16", cfg,
                                              dev))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
