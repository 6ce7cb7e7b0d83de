"""Mamba-2 SSD scan: the CUDA forward kernel with an autograd rule.

``ssd_scan(x, dt, A, B, C, *, chunk)`` has the contract of the reference's
``repro.kernels.ssd_scan.ops.ssd_scan`` and of ``ref.ssd_chunked``: x
(B, L, H, P), dt (B, L, H) (softplus'ed), A (H,) negative, B and C
(B, L, G, N) with G dividing H; it returns (y (B, L, H, P), final state
(B, H, P, N)), fp32.

Forward: on a CUDA tensor ``ssd_scan_fwd`` launches the kernel of
``csrc/ssd_scan.cu`` (built at first use; a failed launch raises) and
counts the launch; on a CPU tensor it takes ``ref.ssd_scan_ref``.  Nothing
falls back from one to the other.  The kernel reads the inputs through
their strides (no repeat of B/C per head, no transposes, no padded copy of
a ragged length).

Backward: ``ref.ssd_chunked`` recomputed under autograd, and its
vector-Jacobian product for (x, dt, A, B, C), on either device: the
reference's own VJP (``jax.vjp`` of ``ssd_chunked``).  A backward kernel
is later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.ssd_scan import ref

MAX_HEAD_DIM = 128      # P (csrc kMaxP)
MAX_STATE = 256         # N (csrc kMaxN)
MAX_CHUNK = 256         # Q (csrc kMaxChunk)


def _validate(x, dt, A, B, C) -> None:
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or B.ndim != 4 or B.shape != C.shape:
        raise ValueError(
            f"ssd_scan wants x (B, L, H, P), dt (B, L, H), A (H,), B and C "
            f"(B, L, G, N); got {[tuple(t.shape) for t in (x, dt, A, B, C)]}")
    b, l, h, _ = x.shape
    if (tuple(dt.shape) != (b, l, h) or tuple(A.shape) != (h,)
            or tuple(B.shape[:2]) != (b, l) or h % B.shape[2] != 0):
        raise ValueError(
            f"ssd_scan: shapes disagree or G does not divide H: "
            f"{[tuple(t.shape) for t in (x, dt, A, B, C)]}")


def ssd_scan_fwd(x, dt, A, B, C, chunk: int):
    """The forward: kernel on CUDA tensors, plain version on CPU tensors."""
    _validate(x, dt, A, B, C)
    if not x.is_cuda:
        return ref.ssd_scan_ref(x, dt, A, B, C, chunk)
    if any(t.device != x.device for t in (dt, A, B, C)):
        raise ValueError(f"ssd_scan inputs on several devices, x on {x.device}")
    if any(t.dtype != torch.float32 for t in (x, dt, A, B, C)):
        raise TypeError(f"the ssd_scan kernel takes float32, got "
                        f"{[t.dtype for t in (x, dt, A, B, C)]}")
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if p > MAX_HEAD_DIM or n > MAX_STATE or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel takes P <= {MAX_HEAD_DIM}, N <= "
                         f"{MAX_STATE}, 1 <= chunk <= {MAX_CHUNK}; got P={p}, "
                         f"N={n}, chunk={chunk}")
    if b * h >= 2 ** 31:
        raise ValueError(f"grid too large for x {tuple(x.shape)}")
    y = torch.empty((b, l, h, p), device=x.device, dtype=torch.float32)
    state = torch.empty((b, h, p, n), device=x.device, dtype=torch.float32)
    rc = build.library().ssd_scan_fwd_f32(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, l, h, p, g, n, chunk,
        *x.stride(), *dt.stride(), A.stride(0), *B.stride(), *C.stride(),
        build.stream_of(x))
    build.check(rc, "ssd_scan_fwd")
    LAUNCHES["ssd_scan_fwd"] += 1
    return y, state


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        y, state = ssd_scan_fwd(x, dt, A, B, C, chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        saved = ctx.saved_tensors          # unpacked once (checkpointing)
        inputs = [t.detach().to(torch.float32).requires_grad_(True)
                  for t in saved]
        with torch.enable_grad():
            y, state = ref.ssd_chunked(*inputs, chunk=ctx.chunk)
            grads = torch.autograd.grad((y, state), inputs, (gy, gstate))
        return (*(g.to(t.dtype) for g, t in zip(grads, saved)), None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int):
    """SSD scan, one kernel launch forward: (y, final state), fp32."""
    return _SSDScan.apply(x, dt, A, B, C, int(chunk))
