#!/usr/bin/env python3
"""Hold two forms of the client-batched conv, flash attention, the SSD scan
or the fused KD-KL forward against the plain version and time them in one
process on one CUDA card, in turns (old, new, new, old).

    python3 tools/ab_kernel_forms.py --old DIR [--interface first|current]

``DIR`` holds the old form's ``grouped_conv.cu``, ``flash_attention.cu``,
``ssd_scan.cu`` and/or ``kd_kl.cu``; each kernel whose source is there is
compared.  For B1's first form (a warp per row, scalar loads, four expf an
element; its entry points are the port's, so either interface binds it):

    git show 11219f7:src/repro_torch/csrc/kd_kl.cu > DIR/kd_kl.cu

Where the old ``flash_attention.cu`` also defines
``flash_attention_fwd_bf16`` (the bf16 form at commit 3c466fa: 3xTF32
``mma.sync`` on widened tiles, before it moved to
``flash_attention_bf16.cu``), that form is held against the port's bf16
form too; its source includes the ``tf32_mma.cuh`` of its commit, which
then goes in ``DIR`` beside it:

    git show 3c466fa:src/repro_torch/csrc/flash_attention.cu > DIR/flash_attention.cu
    git show 3c466fa:src/repro_torch/csrc/tf32_mma.cuh > DIR/tf32_mma.cuh

With ``--interface first`` (the default) they have the C entry points of
the first forms (``FIRST_SIGNATURES``: the conv without the tile-plan
arguments, the SSD scan without the scratch and plan arguments); with
``current`` they have the port's own entry points (a variant of the
current kernel, called with the same plan), and the port's
``tf32_mma.cuh`` is on the include path where ``DIR`` has none.  They are
built with the port's ``nvcc`` flags into ``DIR/libold.so`` and bound with
``ctypes``; the new forms are the port's own
(``repro_torch.kernels.build``).

Both forms run on the same inputs at the ResNet-8 path's conv shapes
(K=4, N=64; K=1 at N=256, 1024 and 788), at ResNet-50's 23 distinct conv
shapes at 64x64 (K=4, N=64; the group's totals count each shape as often
as the network has it), at a 1x1 conv over 2,048 input channels (a deep
reduction, for the error), at the text path's attention
(B=64 and 256), at the LM path's SSD scan (B = 4 and 8 of (B, 1023,
80, 64, 1, 128, 256), inputs strided as ``mamba2_forward`` passes them),
for the bf16 forms of flash attention at ``chip_smoke.BF16_FLASH``, and
for B1 (``kd_kl_fwd_f32`` and ``kd_kl_fwd_bf16``) at ``KD_FWD_SHAPES``:
2,048 rows at every LM vocabulary of the port (phi4-mini, seamless-m4t,
deepseek-v3, llava-next, mixtral), mamba2's (4,092, 50,280) and the main
path's (256, 10), (256, 200) and (1,024, 10), each form's share of its
bound beside its time (``launch.roofline.kd_kl_fwd_cost``: both logits
read once, three (rows,) fp32 outputs written; 12 operations an element
at the fp32 rate).
Each form's largest error against the plain version is printed beside its
time; the run fails if the new form is further than 1e-5 of max|plain|
from it (for the SSD scan, where the fp32 plain version is itself further
than that from float64: no further from float64 than the plain version;
for bf16 flash attention, chip_smoke's bf16 gate: one bf16 ulp of the
fp32 plain version plus 1e-5 of its max, and 2e-2 of the bf16 plain
version; B1's kl and logsumexps each to 1e-5 of their max|plain|, bf16
logits against the fp32 plain version on the same values upcast).
Times are CUDA-graph replays (``chip_smoke.time_ms``).  Imports nothing of
JAX.
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
    "ssd_scan_fwd_f32": [_P] * 7 + [_I64] * 7 + [_I64] * 16 + [_P],
    "flash_attention_fwd_bf16": [_P, _P, _P, _P] + [_I64] * 6 + [_I64] * 12
                                + [_I64, _I64, _F32, _P],
    "kd_kl_fwd_f32": [_P, _P, _P, _P, _P, _I64, _I64, _F32, _F32, _P],
    "kd_kl_fwd_bf16": [_P, _P, _P, _P, _P, _I64, _I64, _F32, _F32, _P],
}
ENTRY = {"grouped_conv.cu": "grouped_conv_fwd_f32",
         "flash_attention.cu": "flash_attention_fwd_f32",
         "ssd_scan.cu": "ssd_scan_fwd_f32",
         "kd_kl.cu": "kd_kl_fwd_f32"}
# B1's (rows, vocab): 2,048 rows at phi4-mini's, seamless-m4t's,
# deepseek-v3's, llava-next's and mixtral's vocabularies, mamba2's step,
# and the main path's FedGKD step, ResNet-50's and the 1M-client cohort's
KD_FWD_SHAPES = [(2048, 200_064), (2048, 256_206), (2048, 129_280),
                 (2048, 64_000), (2048, 32_000), (4092, 50_280), (256, 10),
                 (256, 200), (1024, 10)]
SSD_BATCHES = (4, 8)       # the LM path's step and evaluation
CONV_GROUPS = {"K=4 step": [(4, 64)], "K=1 eval": [(1, 256)],
               "K=1 teacher": [(1, 1024), (1, 788)],
               "R50 K=4 step": [(4, 64)]}
# (name, H, Cin, Cout, k, stride) at K=1, N=2
DEEP = ("1x1 over 2048", 8, 2048, 96, 1, 1)


def build_old(src_dir: Path, interface: str):
    from repro_torch.kernels import build

    srcs = [src_dir / name for name in ENTRY if (src_dir / name).exists()]
    if not srcs:
        raise FileNotFoundError(f"none of {list(ENTRY)} in {src_dir}")
    out = src_dir / "libold.so"
    done = subprocess.run([build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS,
                           "-I", str(build.CSRC), "-shared", "-o", str(out),
                           *map(str, srcs)], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {srcs}:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    sigs = FIRST_SIGNATURES if interface == "first" else build.SIGNATURES
    have = {s.name for s in srcs}
    for src in srcs:
        fn = getattr(lib, ENTRY[src.name])
        fn.argtypes = sigs[ENTRY[src.name]]
        fn.restype = ctypes.c_int
    for extra in ("flash_attention_fwd_bf16", "kd_kl_fwd_bf16"):
        if hasattr(lib, extra):
            getattr(lib, extra).argtypes = sigs[extra]
            getattr(lib, extra).restype = ctypes.c_int
            have.add(extra)
    return lib, have


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
    from chip_smoke import (BF16_FLASH, BF16_FLASH_TOL, LM_SEQ, R50_HW,
                            RESNET8_CONVS, bf16_compare, resnet50_shapes,
                            ssd_inputs, time_ms)
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.grouped_conv import ops, ref
    from repro_torch.kernels.kd_kl import ops as kd_ops
    from repro_torch.kernels.kd_kl import ref as kd_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.launch import roofline

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

    groups = (dict(CONV_GROUPS, deep=[(1, 2)]) if "grouped_conv.cu" in have
              else {})
    for group, calls in groups.items():
        tot_old = tot_new = 0.0
        convs = ([DEEP + (1,)] if group == "deep"
                 else resnet50_shapes(R50_HW) if group.startswith("R50")
                 else [c + (1,) for c in RESNET8_CONVS])
        for k, n in calls:
            for name, h, cin, cout, kk, s, count in convs:
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
                tot_old += count * t_old
                tot_new += count * t_new
                print(f"  conv K={k} N={n:4d} {name:13s} x{count} old "
                      f"{t_old:.4f} ms "
                      f"(err {e_old:.2e}) new {t_new:.4f} ms (err "
                      f"{e_new:.2e}) {t_old / t_new:.2f}x", flush=True)
        print(f"conv group {group}: old {tot_old:.4f} ms new {tot_new:.4f} ms "
              f"({tot_old / tot_new:.2f}x)", flush=True)

    for b in ((64, 256) if "flash_attention.cu" in have else ()):
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

    for b, s, hq, hkv, d, window in (
            BF16_FLASH if "flash_attention_fwd_bf16" in have else ()):
        q = torch.randn(b, s, hq, d, device=dev, generator=gen).bfloat16()
        kt, v = (torch.randn(b, s, hkv, d, device=dev, generator=gen)
                 .bfloat16() for _ in range(2))
        o_old = torch.empty_like(q)
        plan = ([] if args.interface == "first" else
                [fa_ops.launch_plan(b, s, hq, d, torch.bfloat16)[2]])

        def f_old():
            rc = old.flash_attention_fwd_bf16(
                q.data_ptr(), kt.data_ptr(), v.data_ptr(), o_old.data_ptr(),
                b, s, s, hq, hkv, d, *q.stride()[:3], *kt.stride()[:3],
                *v.stride()[:3], *o_old.stride()[:3], 1, window or 0,
                1.0 / math.sqrt(d), *plan, build.stream_of(q))
            build.check(rc, "old flash_attention_fwd_bf16")

        def f_new():
            return fa_ops.flash_attention_fwd(q, kt, v, True, window)

        f_old()
        new = f_new()
        want = fa_ref.attention_ref(q.float(), kt.float(), v.float(),
                                    window=window)
        plain = fa_ref.attention_ref(q, kt, v, window=window).float()
        name = f"flash bf16 {tuple(q.shape)} kv {tuple(kt.shape)}"
        e_old, e_new = (float((y.float() - want).abs().max())
                        for y in (o_old, new))
        bf16_compare(name, new, want)
        if not bool(((new.float() - plain).abs()
                     <= BF16_FLASH_TOL * (1 + plain.abs())).all()):
            raise AssertionError(f"{name}: the new form is past "
                                 f"{BF16_FLASH_TOL} of the bf16 plain version")
        t_old, t_new = turns(f_old, f_new)
        print(f"{name} window {window}: old {t_old:.4f} ms (err {e_old:.2e}) "
              f"new {t_new:.4f} ms (err {e_new:.2e}) {t_old / t_new:.2f}x",
              flush=True)

    for b in (SSD_BATCHES if "ssd_scan.cu" in have else ()):
        shape = (b, LM_SEQ - 1, 80, 64, 1, 128, 256)
        ins = ssd_inputs(dev, gen, *shape[:6])
        x, dt, a, bm, cm = ins
        y_old = torch.empty(b, LM_SEQ - 1, 80, 64, device=dev)
        s_old = torch.empty(b, 80, 64, 128, device=dev)
        strides = (*x.stride(), *dt.stride(), a.stride(0), *bm.stride(),
                   *cm.stride())
        scratch, plan_args = [], []
        if args.interface == "current":
            plan = ssd_ops.ssd_plan(*shape, vec_x=True, vec_bc=True)
            scratch = [torch.empty(s, device=dev) for s in
                       (plan.states_shape, plan.cb_shape, plan.decay_shape)]
            plan_args = [1, 1, plan.chunk_smem, plan.out_smem]

        def f_old():
            rc = old.ssd_scan_fwd_f32(
                *(t.data_ptr() for t in (*ins, y_old, s_old, *scratch)),
                *shape, *strides, *plan_args, build.stream_of(x))
            build.check(rc, "old ssd_scan_fwd")

        def f_new():
            return ssd_ops.ssd_scan_fwd(*ins, 256)

        f_old()
        new = f_new()
        want = ssd_ref.ssd_scan_ref(*ins, 256)
        exact = ssd_ref.ssd_chunked(*(t.double() for t in ins), chunk=256)
        line = f"ssd {shape}:"
        for name, a_old, a_new, w, e in zip(("y", "state"), (y_old, s_old),
                                            new, want, exact):
            e_old, e_new, e_plain = (float((t.double() - e).abs().max())
                                     for t in (a_old, a_new, w))
            if not (float((a_new - w).abs().max())
                    <= 1e-5 * float(w.abs().max()) or e_new <= e_plain):
                raise AssertionError(f"ssd {shape} {name}: the new form is "
                                     f"{e_new} from float64, plain {e_plain}")
            line += (f" {name} vs float64 old {e_old:.2e} new {e_new:.2e} "
                     f"plain {e_plain:.2e};")
        del exact
        t_old, t_new = turns(f_old, f_new)
        print(f"{line} old {t_old:.4f} ms new {t_new:.4f} ms "
              f"{t_old / t_new:.2f}x", flush=True)

    kd_forms = [(torch.float32, "kd_kl_fwd_f32"),
                (torch.bfloat16, "kd_kl_fwd_bf16")]
    for dtype, entry in (kd_forms if "kd_kl.cu" in have else ()):
        if not hasattr(old, entry):
            continue
        for rows, vocab in KD_FWD_SHAPES:
            lt, ls = ((torch.randn(rows, vocab, device=dev, generator=gen)
                       * 2).to(dtype) for _ in range(2))
            outs_old = [torch.empty(rows, device=dev) for _ in range(3)]

            def f_old():
                rc = getattr(old, entry)(
                    lt.data_ptr(), ls.data_ptr(),
                    *(o.data_ptr() for o in outs_old), rows, vocab, 1.0, 1.0,
                    build.stream_of(lt))
                build.check(rc, "old " + entry)

            def f_new():
                return kd_ops.kd_kl_fwd(lt, ls, 1.0)

            f_old()
            new = f_new()
            want = kd_ref.kd_kl_fwd_ref(lt.float(), ls.float(), 1.0)
            e_old = e_new = 0.0
            for name, a_old, a_new, w in zip(("kl", "lse_t", "lse_s"),
                                             outs_old, new, want):
                eo, en = errors(f"{entry} {(rows, vocab)} {name}", a_old,
                                a_new, w)
                e_old, e_new = max(e_old, eo), max(e_new, en)
            bnd, by = roofline.kd_kl_fwd_cost(rows, vocab,
                                              lt.element_size()).bound()
            t_old, t_new = turns(f_old, f_new)
            print(f"{entry} ({rows}, {vocab}): old {t_old:.5f} ms (err "
                  f"{e_old:.2e}, {bnd / t_old:.3f} of the bound) new "
                  f"{t_new:.5f} ms (err {e_new:.2e}, {bnd / t_new:.3f} of "
                  f"it) {t_old / t_new:.2f}x; bound {bnd:.5f} ms ({by})",
                  flush=True)
            del lt, ls, want, new, outs_old
    return 0


if __name__ == "__main__":
    sys.exit(main())
