"""Knowledge-distillation losses and global-model ensembling (paper Eq. 3-5).

The port of ``repro.core.distillation``.  The KD regularizer is
``(γ/2)·E_x[ KL( h(w_teacher; x) ‖ h(w; x) ) ]``, teacher first (forward
KL); ``kd_loss_mse`` is the Table 9 ablation over logits, and
``vote_coefficients`` FedGKD-VOTE's γ_m (Eq. 5).  ``kl_divergence`` runs
through the fused KD-KL kernel (``kernels.kd_kl.ops.kd_kl_loss``) on the
card and its plain version on the CPU; gradients flow to the student
only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kd_kl.ops import kd_kl_loss
from repro_torch.tree import tree_leaves, tree_map


def kl_divergence(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
                  temperature: float = 1.0) -> torch.Tensor:
    """Per-example KL(p_T ‖ p_S)·T². Shapes (..., C) -> (...)."""
    return kd_kl_loss(teacher_logits, student_logits, temperature=temperature)


def masked_mean(values: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Weighted mean; ``mask is None`` is the plain mean.  Zero-weight
    entries contribute nothing to value or gradient."""
    if mask is None:
        return values.mean()
    w = mask.to(torch.float32)
    return torch.sum(values * w) / torch.clamp(torch.sum(w), min=1.0)


def masked_mean_per_client(values: torch.Tensor,
                           mask: torch.Tensor | None) -> torch.Tensor:
    """Row of ``masked_mean``s over a stacked cohort: (K, B) -> (K,)."""
    if mask is None:
        return values.mean(dim=-1)
    w = mask.to(torch.float32)
    return torch.sum(values * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1),
                                                       min=1.0)


def _nll_terms(logits, labels, ignore_index, mask):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    keep = labels != ignore_index
    valid = keep.to(torch.float32)
    if mask is not None:
        valid = valid * mask.to(torch.float32)
    safe = torch.where(keep, labels, torch.zeros_like(labels))
    ll = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return ll * valid, valid


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -1,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE with optional ignore label and per-example weights."""
    ll, valid = _nll_terms(logits, labels, ignore_index, mask)
    return -torch.sum(ll) / torch.clamp(torch.sum(valid), min=1.0)


def cross_entropy_per_client(logits: torch.Tensor, labels: torch.Tensor,
                             ignore_index: int = -1,
                             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-client masked-mean CE: logits (K, B, C) -> (K,)."""
    ll, valid = _nll_terms(logits, labels, ignore_index, mask)
    return -torch.sum(ll, dim=-1) / torch.clamp(torch.sum(valid, dim=-1),
                                                min=1.0)


def param_sq_dist(a, b) -> torch.Tensor:
    """‖a − b‖² over pytrees (FedProx's proximal term)."""
    return sum(torch.sum(torch.square(x.to(torch.float32)
                                      - y.to(torch.float32)))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def param_sq_dist_per_client(stacked, anchor) -> torch.Tensor:
    """‖w_k − anchor‖² per client: leaves ``(K, ...)`` against the shared
    anchor ``(...)`` -> ``(K,)``."""
    total = 0.0
    for s, a in zip(tree_leaves(stacked), tree_leaves(anchor)):
        d = s.to(torch.float32) - a.to(torch.float32)[None]
        total = total + torch.sum(d * d, dim=tuple(range(1, d.ndim)))
    return total


def kd_loss_kl(teacher_logits, student_logits, gamma: float,
               temperature: float = 1.0, mask=None) -> torch.Tensor:
    """Paper Eq.(3) KD term: (γ/2)·mean KL."""
    return 0.5 * gamma * masked_mean(
        kl_divergence(teacher_logits, student_logits, temperature), mask)


def kd_loss_mse(teacher_logits, student_logits, gamma: float,
                mask=None) -> torch.Tensor:
    """Table 9 ablation: (γ/2)·mean squared logit distance, in place of KL."""
    d = teacher_logits.to(torch.float32) - student_logits.to(torch.float32)
    return 0.5 * gamma * masked_mean(torch.sum(torch.square(d), dim=-1), mask)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == labels).to(torch.float32).mean()


def ensemble_average(params_list: list) -> dict:
    """FedGKD fused teacher: weight-space mean of the buffered models."""
    m = len(params_list)
    first, *rest = params_list

    def mean(x, *xs):
        acc = x.to(torch.float32)
        for y in xs:
            acc = acc + y.to(torch.float32)
        return acc / m

    return tree_map(mean, first, *rest)


def vote_coefficients(val_losses: list[float], lam: float = 0.1,
                      beta: float | None = None) -> list[float]:
    """FedGKD-VOTE: γ_m = 2λ·softmax(−L_m/β), β = 1/M by default (the
    paper's); the softmax in float32, the coefficients as Python floats."""
    m = len(val_losses)
    beta = beta if beta is not None else 1.0 / m
    w = torch.softmax(-torch.tensor(val_losses, dtype=torch.float32) / beta,
                      dim=0)
    return [2.0 * lam * float(x) for x in w]
