#!/usr/bin/env python3
"""How a stacked model's layers are taken from their stacked leaves, timed
on seamless-m4t-large-v2's FedGKD round at full width and depth in bf16.

    python3 tools/layer_slices_ab.py

``models.transformer._unstack`` takes a segment's layers with one
``torch.unbind`` a leaf a forward, whose backward stacks the layers'
gradients once.  The earlier form (``select``) indexed every leaf once a
layer (``x[j]``): the backward of each index writes a zero tensor the size
of the whole stack with the layer's gradient in its slice, and autograd sums
the L of them, O(L²) in the depth.  Both forms run the same two rounds of
``chip_smoke.step_rounds`` (``chip_smoke.FAM_FL``: 2 clients x 2 batches of
2 x 1,024 tokens after 384 frames) from the same card-drawn weights, in
turns select, unbind, unbind, select, then one profiled round 2 of each
(``chip_smoke.profile_round``: wall, device busy time, idle share, device
ops).  Their final params must be equal bit for bit: adding zeros is exact.
Needs the card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def run(dev) -> float:
    """The A/B on ``dev``; returns the max abs difference of the two forms'
    final params."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import frontends, transformer
    from repro_torch.tree import tree_leaves, tree_map

    unbind = transformer._unstack

    def select(tree, count):
        return [tree_map(lambda x, j=j: x[j], tree) for j in range(count)]

    forms = {"select": select, "unbind": unbind}
    arch = cs.SEAMLESS_ARCH
    cfg = cs.bf16_config(arch, get_config(arch).n_layers)
    params = cs.card_init(cfg, dev)
    fl = cs.FAM_FL
    batches = cs.family_batches(cfg, dev, fl["clients"], fl["batches"],
                                fl["batch"], fl["seq"],
                                frontends.AUDIO_FRAMES, seed=9)
    print(f"{arch}: {cfg.enc_layers} + {cfg.n_layers} layers, "
          f"{cfg.param_count():,} params, {cfg.param_dtype}", flush=True)
    finals, seconds = {}, {name: [] for name in forms}
    try:
        for name in ("select", "unbind", "unbind", "select"):
            transformer._unstack = forms[name]
            final, hist = cs.step_rounds(name, cfg, params, batches, 2, dev)
            seconds[name].append(hist[1]["seconds"])
            finals.setdefault(name, final)
            del final
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(tree_leaves(finals["select"]),
                                   tree_leaves(finals["unbind"]),
                                   strict=True))
        print(f"max abs param diff, select against unbind: {diff!r}",
              flush=True)
        del finals
        for name in forms:
            transformer._unstack = forms[name]
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            cs.profile_round(dev, f"bf16 {arch} ({name})", lambda cb: (
                cs.step_rounds("", cfg, params, batches, 2, dev,
                               round_callback=cb)))
    finally:
        transformer._unstack = unbind
    for name, runs in seconds.items():
        print(f"{name}: round 2 seconds {runs}", flush=True)
    return diff


def main() -> int:
    import subprocess

    import torch

    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("layer_slices_ab: no CUDA card visible", file=sys.stderr)
        return 1
    # TF32 off, as in chip_smoke.py's runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    build.library()
    if run(torch.device("cuda", 0)) != 0.0:
        print("layer_slices_ab: the two forms' params differ",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
