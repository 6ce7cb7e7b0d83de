#!/usr/bin/env python3
"""Where the bf16 flash-attention forward's time goes on the card, by
ablation: time the port's ``csrc/flash_attention_bf16.cu`` beside copies of
it with one part of the work taken out.

    python3 tools/flash_bf16_ablation.py [--out build/flash_bf16_ablation]

The card's host has no ``ncu``, so a stall breakdown is not available; the
difference between the full kernel and a copy without a part bounds what
that part costs.  The copies compute WRONG results and exist only to be
timed:

  no_exp      P = S - m in place of exp2(S - m): no MUFU.EX2
  no_rescale  O not rescaled by alpha before a tile's P.V
  no_split    P.V as P_hi . V alone: half the P.V products, no P_lo
  no_pv       no P.V products at all
  no_qk       no Q.K^T products (S keeps the first tile's values)
  no_kv_tma   the copying warp brings k and v of the block's first tile
              into every stage and reuses them (one TMA of k and v in all)

Each copy is built with the port's ``nvcc`` flags into its own library
under ``--out`` and bound with the port's C signature; all run on the same
inputs at phi4-mini's FedGKD step (2, 1,024, 24/8, 128) and zamba2's
prefill (4, 1,024, 32/32, 64), causal, two rounds in turn.  The two forms
of ``scaled_dot_product_attention`` in bf16 are timed beside them as the
library's yardstick (the boolean mask; ``is_causal``).  Times are CUDA-graph
replays (``chip_smoke.time_ms``).  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = "flash_attention_bf16.cu"
# (old text, new text) per ablation; each old text must be found
ABLATIONS = {
    "full": [],
    "no_exp": [("const float p = ex2(s[4 * j + 2 * r + e] - m_use);",
                "const float p = s[4 * j + 2 * r + e] - m_use;")],
    "no_rescale": [("""          acc[4 * j + 2 * r] *= alpha;
          acc[4 * j + 2 * r + 1] *= alpha;""", "")],
    "no_split": [("        wgmma_rs<NA>(acc, pl[kk], dv);\n", "")],
    "no_pv": [("        wgmma_rs<NA>(acc, pl[kk], dv);\n", ""),
              ("        wgmma_rs<NA>(acc, ph[kk], dv);\n", "")],
    "no_qk": [("        wgmma_ss_n64(s, da, db, kk > 0);", "")],
    "no_kv_tma": [("        mbar_expect_tx(bar_full + 8 * st, 2 * kv_tile_bytes<NA>());",
                   "        mbar_expect_tx(bar_full + 8 * st, n < kStages ? 2 * kv_tile_bytes<NA>() : 0);"),
                  ("        for (int a = 0; a < NA; ++a) {\n          tma_load(dst",
                   "        for (int a = 0; a < (n < kStages ? NA : 0); ++a) {\n          tma_load(dst"),
                  ("                   64 * a, hk, kv0, b);",
                   "                   64 * a, hk, kv_begin, b);"),
                  ("                   bar_full + 8 * st, 64 * a, hk, kv0, b);",
                   "                   bar_full + 8 * st, 64 * a, hk, kv_begin, b);")],
}
SHAPES = [(2, 1024, 24, 8, 128), (4, 1024, 32, 32, 64)]


def build_all(out: Path) -> dict:
    from repro_torch.kernels import build

    source = (build.CSRC / SOURCE).read_text()
    procs = {}
    for name, edits in ABLATIONS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the text to ablate is not in "
                                   f"{SOURCE} any more; update ABLATIONS")
            text = text.replace(old, new)
        (d / SOURCE).write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared",
             "-o", str(d / "lib.so"), str(d / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{log}")
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                if "Used" in line]
        print(f"  {name}: ptxas {regs}", flush=True)
        fn = ctypes.CDLL(str(out / name / "lib.so")).flash_attention_fwd_bf16
        fn.argtypes = build.SIGNATURES["flash_attention_fwd_bf16"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "flash_bf16_ablation")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_bf16_ablation: no CUDA card visible", file=sys.stderr)
        return 1
    from chip_smoke import time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops, ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; ablated copies of csrc/{SOURCE} (device ms: "
          f"CUDA-graph replays)", flush=True)
    fns = build_all(args.out)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    for b, s, hq, hkv, d in SHAPES:
        q = torch.randn(b, s, hq, d, device=dev, generator=gen).bfloat16()
        k, v = (torch.randn(b, s, hkv, d, device=dev, generator=gen)
                .bfloat16() for _ in range(2))
        o = torch.empty_like(q)
        smem = ops.launch_plan(b, s, hq, d, torch.bfloat16)[2]
        want = ref.attention_ref(q.float(), k.float(), v.float())
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = ref.causal_mask(s, s, device=dev)
        gqa = hkv != hq
        t_mask = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=gqa), reps=5, replays=4)
        t_causal = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=gqa), reps=5, replays=4)
        print(f"(B={b}, S={s}, Hq={hq}, Hkv={hkv}, D={d}), causal: sdpa bf16 "
              f"mask {t_mask:.4f} ms, is_causal {t_causal:.4f} ms", flush=True)
        for rnd in range(2):
            for name, fn in fns.items():
                def call(fn=fn, name=name):
                    build.check(fn(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), b, s, s, hq, hkv, d, *q.stride()[:3],
                        *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], 1,
                        0, 1.0 / math.sqrt(d), smem, build.stream_of(q)),
                        f"flash_attention_fwd_bf16 ({name})")

                call()
                torch.cuda.synchronize()
                err = float((o.float() - want).abs().max())
                print(f"  round {rnd} {name:10s} "
                      f"{time_ms(call, reps=5, replays=4):.4f} ms (err "
                      f"{err:.2e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
