"""Client-batched convolution: the CUDA forward kernel with an autograd rule.

``client_batched_conv(x, w, stride=, padding=)`` convolves K clients'
batches with K different filter stacks in one launch:

    x (K, N, H, W, Cin) (*) w (K, kh, kw, Cin, Cout) -> (K, N, OH, OW, Cout)

Forward: ``grouped_conv_fwd`` launches the kernel of
``csrc/grouped_conv.cu`` on a CUDA tensor (built at first use; a failed
launch raises) and takes ``ref.grouped_conv_ref`` on a CPU tensor.
Backward: ``ref.grouped_conv_dx`` and ``ref.shift_gemm_dw``, per-tap
K-batched matmuls on either device, as the reference's custom VJP computes
them outside Pallas.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.grouped_conv import ref


def _validate(x: torch.Tensor, w: torch.Tensor, padding: str) -> None:
    if x.ndim != 5 or w.ndim != 5:
        raise ValueError(
            f"client_batched_conv wants x (K, N, H, W, Cin) and w "
            f"(K, kh, kw, Cin, Cout); got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[0] != w.shape[0]:
        raise ValueError(f"client axes disagree: x has K={x.shape[0]}, w has "
                         f"K={w.shape[0]}")
    if x.shape[4] != w.shape[3]:
        raise ValueError(f"channels disagree: x has Cin={x.shape[4]}, w has "
                         f"Cin={w.shape[3]}")
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def grouped_conv_fwd(x: torch.Tensor, w: torch.Tensor, stride: int,
                     padding: str) -> torch.Tensor:
    """The forward: kernel on CUDA tensors, plain version on CPU tensors."""
    _validate(x, w, padding)
    if not x.is_cuda:
        return ref.grouped_conv_ref(x, w, stride, padding)
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"grouped_conv kernel takes float32, got {x.dtype} "
                        f"and {w.dtype}")
    x, w = x.contiguous(), w.contiguous()
    k, n, h, wd, cin = x.shape
    kh, kw, cout = w.shape[1], w.shape[2], w.shape[4]
    oh, lo_h, _ = ref.resolve_pads(h, kh, stride, padding)
    ow, lo_w, _ = ref.resolve_pads(wd, kw, stride, padding)
    y = torch.empty((k, n, oh, ow, cout), device=x.device, dtype=x.dtype)
    rc = build.library().grouped_conv_fwd_f32(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), k, n, h, wd, cin, oh, ow,
        cout, kh, kw, stride, lo_h, lo_w, build.stream_of(x))
    build.check(rc, "grouped_conv_fwd")
    LAUNCHES["grouped_conv_fwd"] += 1
    return y


class _ClientBatchedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride: int, padding: str):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return grouped_conv_fwd(x, w, stride, padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ref.grouped_conv_dx(dy, w, ctx.stride, x.shape[2],
                                     x.shape[3], ctx.padding)
        if ctx.needs_input_grad[1]:
            dw = ref.shift_gemm_dw(x, dy, ctx.stride, w.shape[1], w.shape[2],
                                   ctx.padding)
        return dx, dw, None, None


def client_batched_conv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                        padding: str = "SAME") -> torch.Tensor:
    """Per-client convolution over a stacked cohort, one kernel launch."""
    return _ClientBatchedConv.apply(x, w, int(stride), padding)
