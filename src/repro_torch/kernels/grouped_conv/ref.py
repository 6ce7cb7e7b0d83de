"""Plain PyTorch versions of the client-batched convolution.

    x (K, N, H, W, Cin) (*) w (K, kh, kw, Cin, Cout) -> (K, N, OH, OW, Cout)

Every client convolves its own examples with its own filters.  The layouts
are the reference's (NHWC activations, HWIO filters) and so is ``SAME``:
JAX pads ``lo = pad // 2`` before and the rest after, so a stride-2 3x3
conv of 32 pixels pads 0 on top and 1 below (``padding=1`` in
``torch.nn.functional.conv2d`` would shift every output by one pixel).

``grouped_conv_ref`` is the forward kernel's plain version (the CPU path
and the card's yardstick).  ``grouped_conv_dx`` and ``shift_gemm_dw`` are
the gradients, one K-batched matmul per filter tap, used on every device:
the reference computes its gradients outside Pallas too
(``repro.kernels.grouped_conv.ref``).  On the card they run as fp32
matmuls; ``torch.backends.cuda.matmul.allow_tf32`` must stay False (the
default) for fp32 agreement with the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads(size: int, k: int, stride: int) -> tuple[int, int, int]:
    """(out_size, pad_lo, pad_hi) of a SAME conv along one spatial axis."""
    out = -(-size // stride)
    pad = max((out - 1) * stride + k - size, 0)
    lo = pad // 2
    return out, lo, pad - lo


def valid_pads(size: int, k: int, stride: int) -> tuple[int, int, int]:
    return (size - k) // stride + 1, 0, 0


def resolve_pads(size: int, k: int, stride: int, padding: str):
    if padding == "SAME":
        return same_pads(size, k, stride)
    if padding == "VALID":
        return valid_pads(size, k, stride)
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def _tap(xp: torch.Tensor, i: int, j: int, oh: int, ow: int, stride: int):
    """The strided input window that filter tap (i, j) reads: (K, N, OH, OW, C)."""
    return xp[:, :, i:i + (oh - 1) * stride + 1:stride,
              j:j + (ow - 1) * stride + 1:stride, :]


def _padded(x: torch.Tensor, kh: int, kw: int, stride: int, padding: str):
    h, wd = x.shape[2], x.shape[3]
    oh, lo_h, hi_h = resolve_pads(h, kh, stride, padding)
    ow, lo_w, hi_w = resolve_pads(wd, kw, stride, padding)
    return F.pad(x, (0, 0, lo_w, hi_w, lo_h, hi_h)), oh, ow, lo_h, lo_w


def grouped_conv_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     padding: str = "SAME") -> torch.Tensor:
    """Forward: one K-batched matmul per filter tap (implicit im2col)."""
    k, n, _, _, cin = x.shape
    kh, kw, cout = w.shape[1], w.shape[2], w.shape[4]
    xp, oh, ow, _, _ = _padded(x, kh, kw, stride, padding)
    out = x.new_zeros((k, n * oh * ow, cout))
    for i in range(kh):
        for j in range(kw):
            patch = _tap(xp, i, j, oh, ow, stride).reshape(k, n * oh * ow, cin)
            out = out + torch.bmm(patch, w[:, i, j])
    return out.reshape(k, n, oh, ow, cout)


def grouped_conv_dx(dy: torch.Tensor, w: torch.Tensor, stride: int, h: int,
                    wd: int, padding: str = "SAME") -> torch.Tensor:
    """Input gradient: each tap scatters ``dy @ w[:, i, j]ᵀ`` back onto the
    input window it read, then the SAME pads are cropped off."""
    k, n, oh, ow, cout = dy.shape
    kh, kw, cin = w.shape[1], w.shape[2], w.shape[3]
    _, lo_h, hi_h = resolve_pads(h, kh, stride, padding)
    _, lo_w, hi_w = resolve_pads(wd, kw, stride, padding)
    dxp = dy.new_zeros((k, n, h + lo_h + hi_h, wd + lo_w + hi_w, cin))
    dyf = dy.reshape(k, n * oh * ow, cout)
    for i in range(kh):
        for j in range(kw):
            part = torch.bmm(dyf, w[:, i, j].transpose(1, 2))
            _tap(dxp, i, j, oh, ow, stride).add_(part.reshape(k, n, oh, ow, cin))
    return dxp[:, :, lo_h:lo_h + h, lo_w:lo_w + wd].contiguous()


def shift_gemm_dw(x: torch.Tensor, dy: torch.Tensor, stride: int, kh: int,
                  kw: int, padding: str = "SAME") -> torch.Tensor:
    """Weight gradient: dw[k, i, j] = x_tap(i, j)ᵀ · dy, one K-batched GEMM
    per tap."""
    k, n, _, _, cin = x.shape
    oh, ow, cout = dy.shape[2], dy.shape[3], dy.shape[4]
    xp, _, _, _, _ = _padded(x, kh, kw, stride, padding)
    dyf = dy.reshape(k, n * oh * ow, cout)
    taps = [torch.bmm(_tap(xp, i, j, oh, ow, stride)
                      .reshape(k, n * oh * ow, cin).transpose(1, 2), dyf)
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, 1).reshape(k, kh, kw, cin, cout)
