"""GQA self-attention over plain-dict params: training, prefill and decode.

The port of the GQA parts of ``repro.models.attention``: the projections
with RoPE; full self-attention through the flash-attention op
(``kernels.flash_attention.ops.flash_attention_gqa``: the CUDA kernel on a
card, its plain version, the reference's ``causal_mask`` and
``jnp_attention`` in ``kernels.flash_attention.ref``, on the CPU); and
one-token decode over a KV cache (``KVCache``, ``kv_cache_init``,
``kv_cache_update``, ``gqa_decode_step``), a sliding window kept as a
ring buffer whose slots are masked by the positions they hold.  Decode
attends through the masked ``dot_product_attention`` (the reference's,
plain PyTorch: the flash kernel's plain version, whose mask broadcasts to
the (B, Hkv, G, Sq, Skv) logits), as the reference computes it outside
any Pallas kernel.  ``gqa_attention`` is always causal, as the
reference's is.  Caches default to bf16, as the reference's do; a cache
keeps its dtype, the new keys and values cast to it.  MLA is not ported
yet (ROADMAP A15.6).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    dot_product_attention)
from repro_torch.models.layers import (Params, apply_rope, dense,
                                       dense_bias_init, dense_init)


def gqa_init(generator: torch.Generator, d_model: int, n_heads: int,
             n_kv_heads: int, head_dim: int, qkv_bias: bool = False,
             dtype: torch.dtype = torch.float32) -> Params:
    mk = dense_bias_init if qkv_bias else dense_init
    return {
        "wq": mk(generator, d_model, n_heads * head_dim, dtype),
        "wk": mk(generator, d_model, n_kv_heads * head_dim, dtype),
        "wv": mk(generator, d_model, n_kv_heads * head_dim, dtype),
        "wo": dense_init(generator, n_heads * head_dim, d_model, dtype),
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


class KVCache(NamedTuple):
    """Decode-time KV cache; for a sliding window, a ring buffer."""
    k: torch.Tensor          # (B, max_len, Hkv, D)
    v: torch.Tensor          # (B, max_len, Hkv, D)
    length: torch.Tensor     # () int32: tokens written so far (absolute)

    @property
    def max_len(self) -> int:
        return self.k.shape[-3]


def kv_cache_init(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None) -> KVCache:
    """An empty cache, bf16 by default as the reference's."""
    shape = (batch, max_len, n_kv_heads, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def kv_cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                    *, ring: bool = False) -> KVCache:
    """A new cache with S_new tokens appended at ``cache.length`` (S_new is
    1 in decode).  ``ring`` wraps modulo max_len (a sliding window); without
    it the start is clamped so that the tokens fit, as
    ``lax.dynamic_update_slice`` clamps it in the reference."""
    s_new = k_new.shape[1]
    pos = cache.length.to(torch.int64)
    steps = torch.arange(s_new, device=pos.device)
    if ring:
        idx = (pos + steps) % cache.max_len
    else:
        idx = torch.clamp(pos, 0, cache.max_len - s_new) + steps
    k = cache.k.index_copy(1, idx, k_new.to(cache.k.dtype))
    v = cache.v.index_copy(1, idx, v_new.to(cache.v.dtype))
    return KVCache(k, v, cache.length + s_new)


def gqa_decode_step(params: Params, x: torch.Tensor, cache: KVCache, *,
                    n_heads: int, n_kv_heads: int, head_dim: int,
                    window: Optional[int] = None, rope_theta: float = 10000.0,
                    use_rope: bool = True) -> tuple[torch.Tensor, KVCache]:
    """One-token decode.  x (B, 1, d_model): attends over the cache and the
    new token; returns (y (B, 1, d_model), the updated cache)."""
    b, s, _ = x.shape
    positions = (cache.length.to(torch.int64)
                 + torch.arange(s, device=x.device))[None, :].expand(b, s)
    q, k_new, v_new = gqa_project_qkv(params, x, n_heads, n_kv_heads,
                                      head_dim, positions, rope_theta,
                                      use_rope)
    cache = kv_cache_update(cache, k_new, v_new, ring=window is not None)
    slot = torch.arange(cache.max_len, device=x.device)[None, :]
    length = cache.length.to(torch.int64)
    if window is not None:
        # slot j holds the newest token whose absolute position is j modulo
        # the ring's size; it is attended iff that token was written and
        # lies inside the window of the query (the token just appended at
        # length - 1).  With a ring of exactly the window every written slot
        # qualifies; deriving it from positions keeps larger rings right.
        last = length - 1
        slot_pos = last - torch.remainder(last - slot, cache.max_len)
        valid = (slot_pos >= 0) & (slot_pos > last - window)
    else:
        valid = slot < length
    out = dot_product_attention(q, cache.k, cache.v,
                                valid[:, None, None, None, :])
    y = dense(params["wo"], out.reshape(b, s, n_heads * head_dim))
    return y, cache
