"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``*.cu`` file under ``repro_torch/csrc`` (with the ``*.cuh`` headers
beside them) is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) with one ``nvcc`` process per
source, all started together, and the objects are linked into ONE shared
library with a plain C interface.  The library's name carries a digest of
the sources, headers and flags, so a changed source builds anew and an
unchanged one loads from ``<checkout>/build/kernels``, a directory
``.gitignore`` lists.

Importing this module compiles nothing and touches no CUDA API: the CPU
tests import every module of the package.  ``library()`` builds and loads
on the first call; a failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
# C entry points: every pointer and the stream as c_void_p; each returns
# the cudaError_t of its launch (0 = cudaSuccess)
SIGNATURES = {
    "kd_kl_fwd_f32": [_P, _P, _P, _P, _P, _I64, _I64, _F32, _F32, _P],
    "kd_kl_bwd_f32": [_P, _P, _P, _P, _P, _P, _I64, _I64, _F32, _F32, _P],
    # the same on bf16 logits (kl and the logsumexps fp32, dls bf16)
    "kd_kl_fwd_bf16": [_P, _P, _P, _P, _P, _I64, _I64, _F32, _F32, _P],
    "kd_kl_bwd_bf16": [_P, _P, _P, _P, _P, _P, _I64, _I64, _F32, _F32, _P],
    # x, w, y; K, N, H, W, Cin, OH, OW, Cout; kh, kw, stride, pad_top,
    # pad_left; the tile plan (images, rows, cols, Cin chunk, bn, stages,
    # shared-memory bytes); stream
    "grouped_conv_fwd_f32": [_P, _P, _P] + [_I64] * 8 + [_I32] * 5
                            + [_I32] * 7 + [_P],
    # x, dy, dw, the splits' scratch (or NULL); K, N, H, W, Cin, OH, OW,
    # Cout; kh, kw, stride, pad_top, pad_left; the plan (images, rows, cols,
    # Cin chunk, bn, stages, splits, shared-memory bytes); stream
    "grouped_conv_dw_f32": [_P, _P, _P, _P] + [_I64] * 8 + [_I32] * 5
                           + [_I32] * 8 + [_P],
    # q, k, v, o; B, Sq, Skv, Hq, Hkv, D; the (batch, seq, head) strides of
    # q, k, v and o; causal, window; scale; stream
    "flash_attention_fwd_f32": [_P, _P, _P, _P] + [_I64] * 6 + [_I64] * 12
                               + [_I64, _I64, _F32, _P],
    # the same on bf16 q, k, v and o, then the launch plan's shared bytes
    "flash_attention_fwd_bf16": [_P, _P, _P, _P] + [_I64] * 6 + [_I64] * 12
                                + [_I64, _I64, _F32, _I32, _P],
    # logits, out; rows, vocab; 1 / temperature; stream
    "row_lse_f32": [_P, _P, _I64, _I64, _F32, _P],
    "row_lse_bf16": [_P, _P, _I64, _I64, _F32, _P],
    # x, dt, A, B, C, y, state; the scratch: states, cb, decay; batch, L,
    # H, P, G, N, chunk; the strides of x (4), dt (3), A (1), B (4) and C
    # (4); the plan (vec_x, vec_bc, chunk_smem, out_smem); stream
    "ssd_scan_fwd_f32": [_P] * 10 + [_I64] * 7 + [_I64] * 16 + [_I32] * 4
                        + [_P],
    # the state entering the first chunk (B, H, P, N), then the arguments
    # of ssd_scan_fwd_f32
    "ssd_scan_fwd_init_f32": [_P] + [_P] * 10 + [_I64] * 7 + [_I64] * 16
                             + [_I32] * 4 + [_P],
    # the launch floor: an empty kernel; stream
    "empty_launch": [_P],
}

_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG: dict = {}        # {"seconds": float, "ptxas": str, "path": str}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels are built on the card's host")


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile and link the shared library if it is not built yet."""
    srcs = sources()
    out = build_dir / f"librepro_torch_kernels_{_digest(srcs + headers())}.so"
    if out.exists():
        BUILD_LOG.update(seconds=0.0, path=str(out), ptxas="(cached)")
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        procs = []
        for s in srcs:
            obj = Path(tmp) / (s.stem + ".o")
            procs.append((s, obj, subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for s, _, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {s.name}\n{text}")
            if p.returncode != 0:
                failed.append(s.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    BUILD_LOG.update(seconds=time.perf_counter() - t0, path=str(out),
                     ptxas="\n".join(logs))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
