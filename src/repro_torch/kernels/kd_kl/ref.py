"""Plain PyTorch versions of the fused KD-KL kernels and the row logsumexp.

The same functions as ``csrc/kd_kl.cu``, written with ordinary tensor ops:
the CPU path of ``ops.kd_kl_loss`` and ``ops.row_logsumexp`` and the
yardstick the card compares the kernels with.  They materialise both
probability tensors (and the scaled logits), which the kernels never do.
"""
from __future__ import annotations

import torch


def kd_kl_fwd_ref(lt: torch.Tensor, ls: torch.Tensor, temperature: float):
    """(T, V) x (T, V) -> (KL(p_T || p_S)·temp² (T,), lse_t (T,), lse_s (T,))."""
    a = lt.to(torch.float32) / temperature
    b = ls.to(torch.float32) / temperature
    lse_t = torch.logsumexp(a, dim=-1)
    lse_s = torch.logsumexp(b, dim=-1)
    p_t = torch.exp(a - lse_t[:, None])
    kl = torch.sum(p_t * ((a - lse_t[:, None]) - (b - lse_s[:, None])), dim=-1)
    return kl * (temperature * temperature), lse_t, lse_s


def kd_kl_bwd_ref(lt, ls, lse_t, lse_s, g, temperature: float) -> torch.Tensor:
    """d(Σ g·KL·temp²)/d ls = g·(p_S − p_T)·temp, from the saved logsumexps."""
    p_t = torch.exp(lt.to(torch.float32) / temperature - lse_t[:, None])
    p_s = torch.exp(ls.to(torch.float32) / temperature - lse_s[:, None])
    return g[:, None] * (p_s - p_t) * temperature


def row_logsumexp_ref(logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """(T, V) -> (T,) logsumexp(l / temperature) in fp32, any T and V."""
    return torch.logsumexp(logits.to(torch.float32) / temperature, dim=-1)
