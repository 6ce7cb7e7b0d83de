"""Core layers over plain-dict params: initializers, dense, norms, the
SAME max-pool, embeddings, rotary position embeddings, and the GELU and
SwiGLU MLPs.

The port of the parts of ``repro.models.layers`` that ResNet-8/50, the
TOY MLP, the DistilBERT-class text encoder and the LMs use.  The
initializers draw on ``generator``'s device, in fp32, and cast to their
``dtype`` (float32 unless the caller asks), as the reference's do;
without a generator they give meta tensors of the shapes and dtypes
(``const_device``), the dry-run's shape-only init.  The
layers round where the reference's round: ``dense`` and ``unembed`` cast
the weight to x's dtype, the norms and RoPE compute in fp32 and return
x's dtype.  A model whose parameters are fp32 and activations bf16 (the
FedGKD teacher of a bf16 model: ``ensemble_average`` keeps its sum in
fp32) therefore runs every product in bf16, as the reference's does,
where JAX would promote a missing cast and PyTorch would refuse it.  Dense weights are
``(in, out)`` and applied as ``x @ w``; client-stacked params (``w``
(K, in, out), ``b`` (K, out)) against ``x`` (K, B, in) ride the same line
as a K-batched matmul.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

Params = dict  # nested dict of tensors


def trunc_normal(generator: torch.Generator, shape: Sequence[int],
                 std: float, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """Truncated normal at ±2 std (the reference's initializer), drawn in
    fp32 and cast to ``dtype``.

    ``trunc_normal_`` takes ABSOLUTE bounds, hence ``a=-2·std, b=2·std``.
    The tensor lies on ``generator``'s device.  Without a generator it is
    a tensor of the shape and dtype on the meta device, holding no data:
    the shapes of a layer that is never built (``transformer.init``'s
    empty segments)."""
    if generator is None:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    t = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std,
                                b=2.0 * std, generator=generator)
    return t.to(dtype)


def const_device(generator: torch.Generator):
    """Where an initializer makes the leaves it does not draw (zeros, ones,
    fixed ranges): the CPU beside weights drawn on ``generator`` (the
    caller moves the tree where it runs), the meta device without a
    generator, where ``trunc_normal`` draws nothing either: a shape-only
    init."""
    return None if generator is not None else "meta"


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> Params:
    """A bias-free dense layer, trunc-normal at std 1/sqrt(d_in)."""
    return {"w": trunc_normal(generator, (d_in, d_out),
                              std=1.0 / math.sqrt(d_in), dtype=dtype)}


def dense_bias_init(generator: torch.Generator, d_in: int, d_out: int,
                    dtype: torch.dtype = torch.float32) -> Params:
    return {**dense_init(generator, d_in, d_out, dtype),
            "b": torch.zeros((d_out,), dtype=dtype,
                             device=const_device(generator))}


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


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Max over ``window`` x ``window`` windows of ``(..., H, W, C)`` with
    JAX's SAME padding by ``-inf`` (``lax.reduce_window`` with ``"SAME"``):
    ``lo = pad // 2`` before and the rest after, so 3x3 stride 2 on 32
    pads (0, 1), where ``max_pool2d(padding=1)`` would pad (1, 1) and
    shift every window by one.  Any leading axes; ``torch.func.vmap``-safe."""
    *lead, h, w, c = x.shape
    pads = []
    for size in (w, h):                     # F.pad lists the last axis first
        out = -(-size // stride)
        pad = max((out - 1) * stride + window - size, 0)
        pads += [pad // 2, pad - pad // 2]
    y = torch.nn.functional.pad(x.movedim(-1, -3), pads, value=-math.inf)
    y = torch.nn.functional.max_pool2d(y.reshape((-1,) + tuple(y.shape[-3:])),
                                       window, stride)
    return y.reshape(tuple(lead) + tuple(y.shape[-3:])).movedim(-3, -1)


def layernorm_init(d: int, dtype: torch.dtype = torch.float32,
                   device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, fp32, population variance."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, correction=0, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = (y * params["scale"].to(torch.float32)
         + params["bias"].to(torch.float32))
    return y.to(dtype)


def rmsnorm_init(d: int, dtype: torch.dtype = torch.float32,
                 device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, computed in fp32."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dtype)


def embedding_init(generator: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype = torch.float32) -> Params:
    return {"table": trunc_normal(generator, (vocab, d), std=1.0,
                                  dtype=dtype)}


def embed(params: Params, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table at ``ids`` (int32 or int64), ``ids.shape + (d,)``."""
    return torch.nn.functional.embedding(ids, params["table"])


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied output projection: ``x @ table.T`` -> logits."""
    return x @ params["table"].to(x.dtype).T


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Made where they are used: a host tensor copied to the card would
    stop the host until the card caught up, at every attention layer."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """RoPE by split-half rotation.  x (..., seq, heads, head_dim),
    positions (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)        # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                   # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu_mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
                  dtype: torch.dtype = torch.float32) -> Params:
    return {"up": dense_bias_init(generator, d_model, d_ff, dtype),
            "down": dense_bias_init(generator, d_ff, d_model, dtype)}


def gelu_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``down(gelu(up(x)))`` with the tanh approximation, which is
    ``jax.nn.gelu``'s default."""
    return dense(params["down"], torch.nn.functional.gelu(
        dense(params["up"], x), approximate="tanh"))


def swiglu_init(generator: torch.Generator, d_model: int, d_ff: int,
                dtype: torch.dtype = torch.float32) -> Params:
    return {"gate": dense_init(generator, d_model, d_ff, dtype),
            "up": dense_init(generator, d_model, d_ff, dtype),
            "down": dense_init(generator, d_ff, d_model, dtype)}


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``down(silu(gate(x)) * up(x))``."""
    g = torch.nn.functional.silu(dense(params["gate"], x))
    return dense(params["down"], g * dense(params["up"], x))
