"""GQA self-attention over plain-dict params (training / prefill).

The port of the GQA parts of ``repro.models.attention``: the projections
with RoPE, and full self-attention through the flash-attention op
(``kernels.flash_attention.ops.flash_attention_gqa``: the CUDA kernel on a
card, its plain version, the reference's ``causal_mask`` and
``jnp_attention`` in ``kernels.flash_attention.ref``, on the CPU).
``gqa_attention`` is always causal, as the reference's is: the paper's
"encoder" is a causal stack with rotary positions.  Decode, KV caches and
MLA are not ported yet (ROADMAP A15).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
from repro_torch.models.layers import (Params, apply_rope, dense,
                                       dense_bias_init, dense_init)


def gqa_init(generator: torch.Generator, d_model: int, n_heads: int,
             n_kv_heads: int, head_dim: int, qkv_bias: bool = False) -> Params:
    mk = dense_bias_init if qkv_bias else dense_init
    return {
        "wq": mk(generator, d_model, n_heads * head_dim),
        "wk": mk(generator, d_model, n_kv_heads * head_dim),
        "wv": mk(generator, d_model, n_kv_heads * head_dim),
        "wo": dense_init(generator, n_heads * head_dim, d_model),
    }


def gqa_project_qkv(params: Params, x: torch.Tensor, n_heads: int,
                    n_kv_heads: int, head_dim: int, positions: torch.Tensor,
                    rope_theta: float = 10000.0, use_rope: bool = True):
    """x (B, S, d_model) -> q (B, S, Hq, D), k and v (B, S, Hkv, D)."""
    b, s, _ = x.shape
    q = dense(params["wq"], x).reshape(b, s, n_heads, head_dim)
    k = dense(params["wk"], x).reshape(b, s, n_kv_heads, head_dim)
    v = dense(params["wv"], x).reshape(b, s, n_kv_heads, head_dim)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def gqa_attention(params: Params, x: torch.Tensor, *, n_heads: int,
                  n_kv_heads: int, head_dim: int, positions: torch.Tensor,
                  window: Optional[int] = None, rope_theta: float = 10000.0,
                  use_rope: bool = True) -> torch.Tensor:
    """Causal self-attention.  x (B, S, d_model) -> (B, S, d_model)."""
    b, s, _ = x.shape
    q, k, v = gqa_project_qkv(params, x, n_heads, n_kv_heads, head_dim,
                              positions, rope_theta, use_rope)
    out = flash_attention_gqa(q, k, v, causal=True, window=window)
    return dense(params["wo"], out.reshape(b, s, n_heads * head_dim))
