"""Attention over plain-dict params: GQA and MLA, training, prefill and decode.

The port of ``repro.models.attention``.  GQA: the projections
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
keeps its dtype, the new keys and values cast to it.

MLA (DeepSeek-V3's multi-head latent attention: ``MLAConfig``,
``mla_init``, ``mla_attention``, ``MLACache``, ``mla_cache_init``,
``mla_decode_step``): the query through a low-rank down/up projection,
the keys and values through one compressed latent ``c_kv`` of
``kv_lora_rank`` plus one RoPE key head shared by every head, RoPE at the
default theta on both.  The reference computes MLA in einsums outside any
Pallas kernel, so the port's products stay PyTorch products (neither the
flash kernel nor sdpa): each is summed in fp32 from its operands as they
are (the reference's ``preferred_element_type=float32``), with the
reference's casts between them.  Prefill and training materialise every
head's keys and values from the latent; decode keeps the latent and the
RoPE key in the cache (``kv_lora_rank + qk_rope_dim`` values a token a
layer) and absorbs ``wkv_b``'s key half into the query and its value half
into the output (the absorbed form).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    dot_product_attention)
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models.layers import (Params, apply_rope, const_device,
                                       dense, dense_bias_init, dense_init,
                                       rmsnorm, rmsnorm_init)


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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V3)
# ---------------------------------------------------------------------------

class MLAConfig(NamedTuple):
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


def mla_init(generator: torch.Generator, cfg: MLAConfig,
             dtype: torch.dtype = torch.float32) -> Params:
    """The query's down projection, its norm and its up projection to
    (nope + rope) dims a head; the joint down projection to the latent and
    the shared RoPE key, the latent's norm and its up projection to
    (nope key + value) dims a head; the output projection."""
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    return {
        "wq_a": dense_init(generator, cfg.d_model, cfg.q_lora_rank, dtype),
        "q_norm": rmsnorm_init(cfg.q_lora_rank, dtype,
                               const_device(generator)),
        "wq_b": dense_init(generator, cfg.q_lora_rank, h * (dn + dr), dtype),
        "wkv_a": dense_init(generator, cfg.d_model, cfg.kv_lora_rank + dr,
                            dtype),
        "kv_norm": rmsnorm_init(cfg.kv_lora_rank, dtype,
                                const_device(generator)),
        "wkv_b": dense_init(generator, cfg.kv_lora_rank, h * (dn + dv), dtype),
        "wo": dense_init(generator, h * dv, cfg.d_model, dtype),
    }


def _mla_qkv(params: Params, x: torch.Tensor, cfg: MLAConfig,
             positions: torch.Tensor):
    """x (B, S, d_model) -> q_nope (B, S, H, dn), q_rope (B, S, H, dr), the
    normed latent c_kv (B, S, rank) and the shared RoPE key (B, S, dr)."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = dense(params["wq_b"], rmsnorm(params["q_norm"],
                                      dense(params["wq_a"], x)))
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], positions)
    kv_a = dense(params["wkv_a"], x)
    c_kv = rmsnorm(params["kv_norm"], kv_a[..., :cfg.kv_lora_rank])
    k_rope = apply_rope(kv_a[..., None, cfg.kv_lora_rank:], positions)
    return q_nope, q_rope, c_kv, k_rope[..., 0, :]


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def mla_attention(params: Params, x: torch.Tensor, cfg: MLAConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """Causal MLA for training and prefill: every head's keys and values
    made from the latent.  x (B, S, d_model) -> (B, S, d_model)."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, cfg, positions)
    kv = dense(params["wkv_b"], c_kv).reshape(b, s, h, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    scale = 1.0 / math.sqrt(dn + dr)
    logits = (torch.einsum("bqhd,bkhd->bhqk", _f32(q_nope), _f32(k_nope))
              + torch.einsum("bqhd,bkd->bhqk", _f32(q_rope), _f32(k_rope))
              ) * scale
    future = torch.ones((s, s), dtype=torch.bool, device=x.device).triu(1)
    logits = logits.masked_fill(future, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", _f32(probs.to(v.dtype)), _f32(v))
    return dense(params["wo"], out.reshape(b, s, h * dv).to(x.dtype))


class MLACache(NamedTuple):
    """MLA's decode cache: the compressed latent and the shared RoPE key."""
    c_kv: torch.Tensor     # (B, max_len, kv_lora_rank)
    k_rope: torch.Tensor   # (B, max_len, qk_rope_dim)
    length: torch.Tensor   # () int32: tokens written so far

    @property
    def max_len(self) -> int:
        return self.c_kv.shape[-2]


def mla_cache_init(batch: int, max_len: int, cfg: MLAConfig,
                   dtype: torch.dtype = torch.bfloat16,
                   device=None) -> MLACache:
    """An empty cache, bf16 by default as the reference's."""
    return MLACache(
        torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                    device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def mla_decode_step(params: Params, x: torch.Tensor, cache: MLACache,
                    cfg: MLAConfig) -> tuple[torch.Tensor, MLACache]:
    """One-token MLA decode against the compressed cache (the absorbed
    form): the logits are taken in the latent space, ``wkv_b``'s key half
    absorbed into the query, and the output leaves the latent through its
    value half.  x (B, 1, d_model) -> (y (B, 1, d_model), the new cache);
    the new tokens are written at ``cache.length`` (clamped so that they
    fit, as ``lax.dynamic_update_slice`` clamps it)."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    pos = cache.length.to(torch.int64)
    steps = torch.arange(s, device=x.device)
    positions = (pos + steps)[None, :].expand(b, s)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(params, x, cfg, positions)
    idx = torch.clamp(pos, 0, cache.max_len - s) + steps
    c_kv = cache.c_kv.index_copy(1, idx, c_kv_new.to(cache.c_kv.dtype))
    k_rope = cache.k_rope.index_copy(1, idx,
                                     k_rope_new.to(cache.k_rope.dtype))
    new_cache = MLACache(c_kv, k_rope, cache.length + s)

    wkv_b = params["wkv_b"]["w"].reshape(cfg.kv_lora_rank, h, dn + dv)
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]
    q_lat = torch.einsum("bshd,rhd->bshr", _f32(q_nope), _f32(w_k))
    scale = 1.0 / math.sqrt(dn + dr)
    logits = (torch.einsum("bshr,bkr->bhsk", _f32(q_lat.to(c_kv.dtype)),
                           _f32(c_kv))
              + torch.einsum("bshd,bkd->bhsk", _f32(q_rope.to(k_rope.dtype)),
                             _f32(k_rope))) * scale
    valid = (torch.arange(new_cache.max_len, device=x.device)
             < new_cache.length.to(torch.int64))
    logits = logits.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out_lat = torch.einsum("bhsk,bkr->bshr", _f32(probs.to(c_kv.dtype)),
                           _f32(c_kv))
    out = torch.einsum("bshr,rhd->bshd", _f32(out_lat.to(w_v.dtype)),
                       _f32(w_v))
    y = dense(params["wo"], out.reshape(b, s, h * dv).to(x.dtype))
    return y, new_cache
