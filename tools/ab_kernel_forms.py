#!/usr/bin/env python3
"""Hold two forms of the client-batched conv (and of flash attention) against
the plain version and time them in one process on one CUDA card, in turns
(old, new, new, old).

    python3 tools/ab_kernel_forms.py --old DIR [--interface first|current]

``DIR`` holds the old form's ``grouped_conv.cu`` and, optionally,
``flash_attention.cu``.  With ``--interface first`` (the default) they have
the C entry points of the first forms (the conv without the tile-plan
arguments); with ``current`` they have the port's own entry points (a
variant of the current kernel, called with the same tile plan), and
``tf32_mma.cuh`` is on the include path.  They are built with the port's
``nvcc`` flags into ``DIR/libold.so`` and bound with ``ctypes``; the new
forms are the port's own (``repro_torch.kernels.build``).

Both forms run on the same inputs at the ResNet-8 path's conv shapes
(K=4, N=64; K=1 at N=256, 1024 and 788), at a 1x1 conv over 2,048 input
channels (a deep reduction, for the error), and at the text path's
attention (B=64 and 256).  Each form's largest error against the plain
version is printed beside its time; the run fails if the new form is
further than 1e-5 of max|plain| from it.  Times are CUDA-graph replays
(``chip_smoke.time_ms``).  Imports nothing of JAX.
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

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
FIRST_SIGNATURES = {
    "grouped_conv_fwd_f32": [_P, _P, _P] + [_I64] * 8 + [_I32] * 5 + [_P],
    "flash_attention_fwd_f32": [_P, _P, _P, _P] + [_I64] * 6 + [_I64] * 12
                               + [_I64, _I64, _F32, _P],
}
CONV_GROUPS = {"K=4 step": [(4, 64)], "K=1 eval": [(1, 256)],
               "K=1 teacher": [(1, 1024), (1, 788)]}
# (name, H, Cin, Cout, k, stride) at K=1, N=2
DEEP = ("1x1 over 2048", 8, 2048, 96, 1, 1)


def build_old(src_dir: Path, interface: str):
    from repro_torch.kernels import build

    srcs = [p for p in (src_dir / "grouped_conv.cu",
                        src_dir / "flash_attention.cu") if p.exists()]
    out = src_dir / "libold.so"
    done = subprocess.run([build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS,
                           "-I", str(build.CSRC), "-shared", "-o", str(out),
                           *map(str, srcs)], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {srcs}:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    sigs = FIRST_SIGNATURES if interface == "first" else build.SIGNATURES
    names = {"grouped_conv.cu": "grouped_conv_fwd_f32",
             "flash_attention.cu": "flash_attention_fwd_f32"}
    for src in srcs:
        fn = getattr(lib, names[src.name])
        fn.argtypes = sigs[names[src.name]]
        fn.restype = ctypes.c_int
    return lib, {s.name for s in srcs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory of the old form's .cu sources")
    ap.add_argument("--interface", choices=("first", "current"),
                    default="first",
                    help="the C entry points the old sources have")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_kernel_forms: no CUDA card visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import RESNET8_CONVS, time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.grouped_conv import ops, ref

    old, have = build_old(args.old, args.interface)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; old form from {args.old} ({args.interface} "
          f"interface)", flush=True)

    def errors(name, y_old, y_new, want):
        e_old, e_new = (float((y - want).abs().max()) for y in (y_old, y_new))
        if not e_new <= 1e-5 * max(float(want.abs().max()), 1e-30):
            raise AssertionError(f"{name}: the new form is {e_new} from the "
                                 f"plain version")
        return e_old, e_new

    def turns(f_old, f_new):
        a, b, c, d = time_ms(f_old), time_ms(f_new), time_ms(f_new), time_ms(f_old)
        return (a + d) / 2, (b + c) / 2

    groups = dict(CONV_GROUPS, deep=[(1, 2)])
    for group, calls in groups.items():
        tot_old = tot_new = 0.0
        for k, n in calls:
            for name, h, cin, cout, kk, s in ([DEEP] if group == "deep"
                                              else RESNET8_CONVS):
                x = torch.randn(k, n, h, h, cin, device=dev, generator=gen)
                w = torch.randn(k, kk, kk, cin, cout, device=dev,
                                generator=gen) / math.sqrt(kk * kk * cin)
                oh, lo, _ = ref.same_pads(h, kk, s)
                plan = ops.conv_plan(k, n, h, h, cin, cout, kk, kk, s, "SAME")
                tail = ([] if args.interface == "first" else
                        [plan.tile_imgs, plan.tile_rows, plan.tile_cols,
                         plan.chunk, plan.bn, plan.stages, plan.smem_bytes])
                y_old = torch.empty(k, n, oh, oh, cout, device=dev)

                def f_old():
                    rc = old.grouped_conv_fwd_f32(
                        x.data_ptr(), w.data_ptr(), y_old.data_ptr(), k, n, h,
                        h, cin, oh, oh, cout, kk, kk, s, lo, lo, *tail,
                        build.stream_of(x))
                    build.check(rc, "old grouped_conv_fwd")

                def f_new():
                    return ops.grouped_conv_fwd(x, w, s, "SAME")

                f_old()
                e_old, e_new = errors(f"conv K={k} N={n} {name}", y_old,
                                      f_new(), ref.grouped_conv_ref(x, w, s, "SAME"))
                t_old, t_new = turns(f_old, f_new)
                tot_old += t_old
                tot_new += t_new
                print(f"  conv K={k} N={n:4d} {name:13s} old {t_old:.4f} ms "
                      f"(err {e_old:.2e}) new {t_new:.4f} ms (err "
                      f"{e_new:.2e}) {t_old / t_new:.2f}x", flush=True)
        print(f"conv group {group}: old {tot_old:.4f} ms new {tot_new:.4f} ms "
              f"({tot_old / tot_new:.2f}x)", flush=True)

    if "flash_attention.cu" not in have:
        return 0
    for b in (64, 256):
        q, kt, v = (torch.randn(b, 64, 4, 32, device=dev, generator=gen)
                    for _ in range(3))
        o_old = torch.empty_like(q)

        def f_old():
            rc = old.flash_attention_fwd_f32(
                q.data_ptr(), kt.data_ptr(), v.data_ptr(), o_old.data_ptr(),
                b, 64, 64, 4, 4, 32, *q.stride()[:3], *kt.stride()[:3],
                *v.stride()[:3], *o_old.stride()[:3], 1, 0,
                1.0 / math.sqrt(32), build.stream_of(q))
            build.check(rc, "old flash_attention_fwd")

        def f_new():
            return fa_ops.flash_attention_fwd(q, kt, v, True)

        f_old()
        e_old, e_new = errors(f"flash B={b}", o_old, f_new(),
                              fa_ref.attention_ref(q, kt, v))
        t_old, t_new = turns(f_old, f_new)
        print(f"flash (B={b}, 64, 4, 4, 32) causal: old {t_old:.5f} ms (err "
              f"{e_old:.2e}) new {t_new:.5f} ms (err {e_new:.2e}) "
              f"{t_old / t_new:.2f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
