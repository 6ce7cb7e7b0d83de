#!/usr/bin/env python3
"""Where the SSD scan's time goes on the card, by ablation: time the port's
``csrc/ssd_scan.cu`` beside copies of it with one part of the work taken
out, each stage's device time read from ``torch.profiler``.

    python3 tools/ssd_ablation.py [--batch 4] [--out build/ssd_ablation]

The card's host has no ``ncu``, so a stall breakdown is not available; the
difference between the full kernel and a copy without a part bounds what
that part costs.  The copies compute WRONG results (their error against the
plain version is printed to show it) and exist only to be timed:

  one_mma   each 3xTF32 product as one TF32 product (hi x hi, no fp32 flush)
  no_split  the operands passed to the tensor cores unsplit (hi = lo = x)
  no_flush  the three products accumulated on the tensor cores, not summed
            from zero and added in fp32 per 8-deep step
  no_decay  the output kernel's M = C.B^T without exp(cum_i - cum_j) dt_j
  no_state  the output kernel without the incoming state's C.S^T
  no_diag   the output kernel without the in-chunk (C.B^T o decay) x
  no_stage  the output kernel without staging x, C and S (cp.async)

Each copy is built with the port's ``nvcc`` flags into its own library
under ``--out`` and bound with the port's C signature; all run on the same
inputs at the LM path's (B, 1023, 80, 64, 1, 128, 256), strided as
``mamba2_forward`` passes them, two rounds in turn.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# the three 3xTF32 products of tf32_mma.cuh mma3_add and their fp32 flush
MMA3 = """  float d[4];
  mma_from_zero(d, a_lo, b0.hi, b1.hi);
  mma(d, a_hi, b0.lo, b1.lo);
  mma(d, a_hi, b0.hi, b1.hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];"""
SPLIT = """  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};"""
# (file, old text, new text) per ablation; each old text must be found
ABLATIONS = {
    "full": [],
    "one_mma": [("tf32_mma.cuh", MMA3, "  mma(c, a_hi, b0.hi, b1.hi);")],
    "no_split": [("tf32_mma.cuh", SPLIT,
                  "  return {__float_as_uint(x), __float_as_uint(x)};")],
    "no_flush": [("tf32_mma.cuh", MMA3, """  mma(c, a_lo, b0.hi, b1.hi);
  mma(c, a_hi, b0.lo, b1.lo);
  mma(c, a_hi, b0.hi, b1.hi);""")],
    "no_decay": [("ssd_scan.cu", """          return j <= i && i < nrows
                     ? cb_ij * exp2f(static_cast<float>(cum[i] - cum[j])) *
                           dts[j]
                     : 0.f;""", "          return cb_ij;")],
    "no_state": [("ssd_scan.cu", "  if (z > 0) {\n    const float* csrc",
                  "  if (false) {\n    const float* csrc")],
    "no_diag": [("ssd_scan.cu", "for (int jt = 0; jt <= it; ++jt) {",
                 "for (int jt = 0; jt < 0; ++jt) {")],
    "no_stage": [("ssd_scan.cu", "stage_tile<Pp, kTileK>(",
                  "if (false) stage_tile<Pp, kTileK>("),
                 ("ssd_scan.cu", "stage_tile<kTile, Pp>(",
                  "if (false) stage_tile<kTile, Pp>("),
                 ("ssd_scan.cu", """      stage_tile<kTile, kTileK>(cbuf, kLdK, csrc + n0 * pb.cs.e, pb.cs.l,
                                pb.cs.e, nrows - i0, pb.N - n0, pb.vec_bc);""",
                  "")],
}


def build_all(out: Path) -> dict:
    from repro_torch.kernels import build

    sources = {name: (build.CSRC / name).read_text()
               for name in ("ssd_scan.cu", "tf32_mma.cuh")}
    procs = {}
    for name, edits in ABLATIONS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        text = dict(sources)
        for fname, old, new in edits:
            if old not in text[fname]:
                raise RuntimeError(f"{name}: the text to ablate is not in "
                                   f"{fname} any more; update ABLATIONS")
            text[fname] = text[fname].replace(old, new)
        for fname, body in text.items():
            (d / fname).write_text(body)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared",
             "-o", str(d / "lib.so"), str(d / "ssd_scan.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{log}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.ssd_scan_fwd_f32.argtypes = build.SIGNATURES["ssd_scan_fwd_f32"]
        lib.ssd_scan_fwd_f32.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ssd_ablation")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ssd_ablation: no CUDA card visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import LM_SEQ, PORT_KERNELS, ssd_inputs, time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ops, ref

    libs = build_all(args.out)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    shape = (args.batch, LM_SEQ - 1, 80, 64, 1, 128, 256)
    ins = ssd_inputs(dev, torch.Generator(device=dev).manual_seed(5),
                     *shape[:6])
    x, dt, a, bm, cm = ins
    plan = ops.ssd_plan(
        *shape, vec_x=ops.copy16(x.data_ptr(), x.stride(), 64),
        vec_bc=(ops.copy16(bm.data_ptr(), bm.stride(), 128)
                and ops.copy16(cm.data_ptr(), cm.stride(), 128)))
    y = torch.empty(*shape[:4], device=dev)
    state = torch.empty(shape[0], 80, 64, 128, device=dev)
    scratch = [torch.empty(s, device=dev) for s in
               (plan.states_shape, plan.cb_shape, plan.decay_shape)]
    strides = (*x.stride(), *dt.stride(), a.stride(0), *bm.stride(),
               *cm.stride())
    want = ref.ssd_scan_ref(*ins, 256)[0]
    print(f"card: {card}; SSD scan at {shape}, ablated copies of "
          f"csrc/ssd_scan.cu (device ms: CUDA-graph replays; per kernel: "
          f"torch.profiler, mean of 10 calls)", flush=True)
    for _ in range(2):
        for name, lib in libs.items():
            def call():
                rc = lib.ssd_scan_fwd_f32(
                    *(t.data_ptr() for t in (*ins, y, state, *scratch)),
                    *shape, *strides, int(plan.vec_x), int(plan.vec_bc),
                    plan.chunk_smem, plan.out_smem, build.stream_of(x))
                build.check(rc, f"ssd_scan_fwd ({name})")

            call()
            torch.cuda.synchronize()
            err = float((y - want).abs().max())
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            stages = []
            for e in prof.key_averages():
                hit = [k for k in PORT_KERNELS if k in e.key]
                if hit:
                    t = (getattr(e, "device_time_total", None)
                         or e.cuda_time_total)
                    stages.append(f"{hit[0]} {t / 10 / 1e3:.4f}")
            print(f"  {name:9s} {time_ms(call, reps=5, replays=4):.4f} ms "
                  f"(y err {err:.2e}): " + ", ".join(sorted(stages)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
