"""Mixture-of-Experts: the top-k router and the capacity-bucketed dispatch.

The port of ``repro.models.moe``: Mixtral-style top-k with softmax gates
over the top-k logits, or DeepSeek-V3-style sigmoid scores renormalised
over the top-k, with optional shared experts, GShard capacity buckets per
token group and the Switch load-balance loss.

The reference dispatches with one-hot einsums into (G, E, C) tensors, the
natural form for the MXU.  The port computes the same function by index
operations and never builds those tensors:

1. the slot of each (token, choice) is its rank among the earlier entries
   of the token-major, choice-minor flattening that chose the same expert
   (so a token's second choice may take a slot before a later token's
   first); entries ranked at ``cap`` or beyond are dropped, their gate
   set to 0, and the token keeps only its residual;
2. each kept entry's token is gathered into an (E, C, D) bucket (empty
   slots hold zeros), and the three expert products run as ``torch.bmm``
   over E;
3. each token's output is the sum of its kept rows weighted by its gates,
   the gates rounded to x's dtype first and the sum taken in fp32 (a dot
   of x's dtype that accumulates in fp32, as the reference's combine
   einsum is).

The router sees x in fp32 and its weight stays fp32 whatever the model's
dtype; the expert weights are cast to x's dtype.  Ties in the top-k go to
the lower expert index, as ``lax.top_k`` breaks them.  Groups of
``group_size`` tokens each have their own capacity, and the loss is the
mean over groups.  The reference's ``batched_groups``, ``dp_axis`` and
``ep_axis`` choose between a scan and a vmap over groups and place the
tensors on a mesh; outside a mesh they change no value, so the port keeps
the fields and ignores them (all groups go through one batched dispatch).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import Params, dense_init


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    shared_d_ff: int = 0      # hidden of the shared expert (0 -> d_ff)
    capacity_factor: float = 1.25
    group_size: int = 4096    # tokens per dispatch group
    router_type: str = "softmax"  # "softmax" (mixtral) | "sigmoid" (deepseek-v3)
    aux_loss_coef: float = 0.01
    batched_groups: bool = False  # the reference's scan-or-vmap choice: N/A
    dp_axis: object = None        # the reference's mesh axes: N/A
    ep_axis: object = None


def moe_init(generator: torch.Generator, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32) -> Params:
    """``router`` (fp32 whatever ``dtype``), the experts' ``gate``, ``up``
    (E, D, F) and ``down`` (E, F, D), and ``shared``, a SwiGLU of
    ``n_shared_experts · (shared_d_ff or d_ff)``, where the config has
    shared experts."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p: Params = {
        "router": dense_init(generator, d, e, torch.float32),
        "gate": layers.trunc_normal(generator, (e, d, f), std=1.0 / math.sqrt(d),
                                    dtype=dtype),
        "up": layers.trunc_normal(generator, (e, d, f), std=1.0 / math.sqrt(d),
                                  dtype=dtype),
        "down": layers.trunc_normal(generator, (e, f, d),
                                    std=1.0 / math.sqrt(f), dtype=dtype),
    }
    if cfg.n_shared_experts:
        sf = (cfg.shared_d_ff or cfg.d_ff) * cfg.n_shared_experts
        p["shared"] = layers.swiglu_init(generator, d, sf, dtype)
    return p


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` as its CPU and CUDA kernels compute it, int64
    zeros with ones scattered in, on every device alike: on meta tensors
    ``F.one_hot`` compares against an ``arange`` instead, which a dry-run
    would count in place of the card's operations, and on the CPU it reads
    the indices' range on the host first."""
    out = torch.zeros(tuple(idx.shape) + (n,), dtype=torch.int64,
                      device=idx.device)
    return out.scatter_(-1, idx.unsqueeze(-1).to(torch.int64), 1)


def _top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, ties to the lower index (a stable
    descending sort; ``torch.topk`` does not promise an order for ties)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_probs(params: Params, x: torch.Tensor, cfg: MoEConfig):
    """(gates (..., k) fp32, expert indices (..., k), full probabilities
    (..., E) fp32) of x (..., D)."""
    logits = layers.dense(params["router"], x.to(torch.float32))
    if cfg.router_type == "sigmoid":
        scores = torch.sigmoid(logits)
        top_vals, top_idx = _top_k(scores, cfg.top_k)
        gates = top_vals / (top_vals.sum(-1, keepdim=True) + 1e-20)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-20)
    else:
        top_vals, top_idx = _top_k(logits, cfg.top_k)
        gates = torch.softmax(top_vals, dim=-1)
        probs = torch.softmax(logits, dim=-1)
    return gates, top_idx, probs


def capacity(group: int, cfg: MoEConfig) -> int:
    """Slots an expert has in a group of ``group`` tokens."""
    return max(1, int(math.ceil(group * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def dispatch_plan(top_idx: torch.Tensor, cap: int, n_experts: int):
    """Where each (group, token, choice) of ``top_idx`` (N, G, k) goes:
    (its slot in the (E, N·cap) buckets, flattened expert-major; whether
    it was kept).  A dropped entry's slot is ``E·N·cap``, one past the
    buckets."""
    n, g, k = top_idx.shape
    flat = top_idx.reshape(n, g * k)
    # the scan runs along the last axis: a CUDA scan over the G·k entries
    # of each expert's row, not down E columns
    onehot = one_hot(flat, n_experts).transpose(1, 2).contiguous()
    before = onehot.cumsum(2) - onehot                        # (N, E, G·k)
    pos = before.gather(1, flat[:, None, :])[:, 0]            # (N, G·k)
    keep = pos < cap
    group = torch.arange(n, device=top_idx.device)[:, None]
    slot = flat * (n * cap) + group * cap + pos
    slot = torch.where(keep, slot, torch.full_like(slot, n_experts * n * cap))
    return slot.reshape(n, g, k), keep.reshape(n, g, k)


def _dispatch(params: Params, xg: torch.Tensor, cfg: MoEConfig):
    """Token groups xg (N, G, D) -> (out (N, G, D), the mean over groups of
    each group's load-balance loss)."""
    n, g, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(g, cfg)
    gates, top_idx, probs = router_probs(params, xg, cfg)
    slot, keep = dispatch_plan(top_idx, cap, e)
    gates = gates * keep

    # each bucket slot's token (row n·G + t of xg), or the zero row n·G
    n_slots = e * n * cap
    token = (torch.arange(n * g, device=xg.device)[:, None]
             .expand(n * g, k).reshape(-1))
    src = torch.full((n_slots + 1,), n * g, dtype=torch.int64,
                     device=xg.device)
    src = src.scatter(0, slot.reshape(-1), token)[:n_slots]
    xpad = torch.cat([xg.reshape(n * g, d), xg.new_zeros(1, d)])
    xe = xpad[src].reshape(e, n * cap, d)

    dt = xg.dtype
    h = F.silu(torch.bmm(xe, params["gate"].to(dt)))
    h = h * torch.bmm(xe, params["up"].to(dt))
    ye = torch.bmm(h, params["down"].to(dt))                  # (E, N·cap, D)

    ypad = torch.cat([ye.reshape(n_slots, d), ye.new_zeros(1, d)])
    rows = ypad[slot.reshape(-1)].reshape(n, g, k, d)
    w = gates.to(dt).to(torch.float32)
    out = (w[..., None] * rows.to(torch.float32)).sum(2).to(dt)

    # Switch-style load balance: E · Σ_e f_e · p_e / k, f_e of kept entries
    kept = one_hot(top_idx, e) * keep[..., None]            # (N, G, k, E)
    f_e = kept.sum(2).to(torch.float32).mean(1)               # (N, E)
    p_e = probs.mean(1)
    aux = e * (f_e * p_e).sum(-1) / k
    return out, aux.mean()


def moe_apply(params: Params, x: torch.Tensor,
              cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, the load-balance loss
    times ``aux_loss_coef``, fp32).  The B·S tokens go in groups of
    ``min(group_size, B·S)``, which must divide B·S."""
    b, s, d = x.shape
    t = b * s
    gsz = min(cfg.group_size, t)
    n_groups = t // gsz
    if n_groups * gsz != t:
        raise ValueError(f"tokens {t} not divisible by group {gsz}")
    xf = x.reshape(t, d)
    out, aux = _dispatch(params, xf.reshape(n_groups, gsz, d), cfg)
    out = out.reshape(t, d)
    if cfg.n_shared_experts:
        out = out + layers.swiglu(params["shared"], xf)
    return out.reshape(b, s, d), aux * cfg.aux_loss_coef


def moe_active_params(cfg: MoEConfig) -> int:
    """Per-token active parameter count of the expert block."""
    routed = 3 * cfg.d_model * cfg.d_ff * cfg.top_k
    shared = 3 * cfg.d_model * (cfg.shared_d_ff or cfg.d_ff) * cfg.n_shared_experts
    router = cfg.d_model * cfg.n_experts
    return routed + shared + router
