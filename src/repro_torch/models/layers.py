"""Core layers over plain-dict params: initializers, dense, GroupNorm.

The port of the parts of ``repro.models.layers`` that ResNet-8 uses.
Dense weights are ``(in, out)`` and applied as ``x @ w``; client-stacked
params (``w`` (K, in, out), ``b`` (K, out)) against ``x`` (K, B, in) ride
the same line as a K-batched matmul.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

Params = dict  # nested dict of tensors


def trunc_normal(generator: torch.Generator, shape: Sequence[int],
                 std: float) -> torch.Tensor:
    """fp32 truncated normal at ±2 std (the reference's initializer).

    ``trunc_normal_`` takes ABSOLUTE bounds, hence ``a=-2·std, b=2·std``."""
    t = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std,
                                b=2.0 * std, generator=generator)
    return t


def dense_bias_init(generator: torch.Generator, d_in: int,
                    d_out: int) -> Params:
    return {"w": trunc_normal(generator, (d_in, d_out),
                              std=1.0 / math.sqrt(d_in)),
            "b": torch.zeros((d_out,))}


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)``; a stacked ``b`` (K, out) broadcasts over the
    activation axes between K and out."""
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        b = params["b"].to(x.dtype)
        if b.ndim == 2:
            b = b.reshape((b.shape[0],) + (1,) * (y.ndim - 2) + (-1,))
        y = y + b
    return y


def groupnorm_init(channels: int) -> Params:
    return {"scale": torch.ones((channels,)), "bias": torch.zeros((channels,))}


def groupnorm(params: Params, x: torch.Tensor, num_groups: int,
              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over ``(..., H, W, C)``: per (leading..., group) over
    (H, W, channels-in-group), population variance as ``jnp.var``.
    Client-stacked ``(K, C)`` scale/bias apply to ``(K, B, H, W, C)``."""
    *lead, h, w, c = x.shape
    dtype = x.dtype
    x = x.to(torch.float32).reshape(*lead, h, w, num_groups, c // num_groups)
    dims = (-4, -3, -1)
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, correction=0, keepdim=True)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(*lead, h, w, c)
    scale, bias = params["scale"], params["bias"]
    if scale.ndim == 2:
        scale = scale[:, None, None, None, :]
        bias = bias[:, None, None, None, :]
    return (x * scale + bias).to(dtype)
