"""Plain PyTorch attention: the function the flash kernel computes.

A port of ``repro.models.attention``'s ``causal_mask`` and
``dot_product_attention``: grouped-query heads by head grouping, masked
logits set to ``-2**30`` (finite, so a row is never NaN), softmax in fp32.
It rounds where the reference rounds: the logits are summed in fp32 from
q and k as they are, the probabilities are cast to v's dtype before P·V
(so bf16 under a bf16 v), P·V is summed in fp32 and the output cast to
q's dtype.  (The products of two bf16 values are exact in fp32, so fp32
arithmetic on upcast operands is the reference's
``preferred_element_type=float32``.)
It is the CPU path of ``ops.flash_attention_gqa`` and the yardstick the
card compares the kernel with; nothing on the card's path calls it.  It
materialises the (B, Hkv, G, Sq, Skv) logits, which the kernel never does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def causal_mask(q_len: int, kv_len: int, *, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """(q_len, kv_len) bool, True = attend: key j <= query i, and with a
    window also j > i - window."""
    q_pos = torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def attention_probs(q: torch.Tensor, k: torch.Tensor,
                    mask: Optional[torch.Tensor],
                    scale: Optional[float] = None) -> torch.Tensor:
    """fp32 softmax probabilities (B, Hkv, G, Sq, Skv) of q (B, Sq, Hq, D)
    against k (B, Skv, Hkv, D), G = Hq / Hkv: query head h reads kv head
    h // G, as the reference groups the heads."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    return torch.softmax(logits, dim=-1)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor],
                          scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), Hq % Hkv == 0 -> (B, Sq, Hq, D).
    ``mask`` (Sq, Skv) or ``None``."""
    b, sq, hq, d = q.shape
    probs = attention_probs(q, k, mask, scale)
    out = torch.einsum("bhgqk,bkhd->bqhgd",
                       probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Attention with the structured mask (the reference's ``attention_ref``
    and ``jnp_attention``); ``window`` takes effect with ``causal`` only."""
    mask = (causal_mask(q.shape[1], k.shape[1], window=window,
                        device=q.device) if causal else None)
    return dot_product_attention(q, k, v, mask)
