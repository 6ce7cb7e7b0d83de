"""A dense decoder LM and its FedGKD rounds, plain PyTorch in fp32.

The model of the port's dense configs (``frozen.layouts.dense_lm_layout``):
token embedding, pre-norm layers of causal grouped-query attention (query
head h reads key/value head h // G) with RoPE by split-half rotation on
every head dimension, a SwiGLU MLP ``down(silu(gate(x)) * up(x))``,
RMSNorm (eps 1e-6) before each and at the end, and logits from the tied
token table.  Each layer and each block of logit rows is recomputed in the
backward (``torch.utils.checkpoint``), so a step fits beside the round's
parameter sets.

``fedgkd_rounds`` replays the first rounds of ``launch.train.run_serial``
with FedGKD on the same inputs: the clients' Markov token batches drawn
from their seeds, the teacher the mean of the last M global models (in
round 1 the initial model), each client's SGD with momentum on CE +
(γ/2)·KL from the global model, the mean of the clients' models, and the
evaluation batch's CE.

``quant="fp8"`` is the control: both operands of every projection and of
the logits rounded to float8 e4m3 with a per-tensor scale (a straight-
through gradient), the precision a later change to the bf16 port could be
tempted into.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cardbench.frozen import data as fdata
from cardbench.frozen import layouts
from cardbench.reference import common as C

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    s = E4M3_MAX / t.detach().abs().amax().clamp(min=1e-12)
    q = (t.detach() * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    return t + (q - t.detach())


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    w = w.float()
    return _fp8(x) @ _fp8(w) if quant == "fp8" else x @ w


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)
            * scale.float())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D): split-half rotation at position s."""
    d, s = x.shape[-1], x.shape[1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(cfg: dict, quant, h, n1, n2, wq, wk, wv, wo, gate, up, down):
    b, s, _ = h.shape
    hq, hkv, d = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    x = _rms(h, n1)
    q = _rope(_mm(x, wq, quant).reshape(b, s, hq, d), cfg["rope_theta"])
    k = _rope(_mm(x, wk, quant).reshape(b, s, hkv, d), cfg["rope_theta"])
    v = _mm(x, wv, quant).reshape(b, s, hkv, d)
    k = k.repeat_interleave(hq // hkv, dim=2)
    v = v.repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, hq * d)
    h = h + _mm(o, wo, quant)
    x = _rms(h, n2)
    return h + _mm(F.silu(_mm(x, gate, quant)) * _mm(x, up, quant), down,
                   quant)


def hidden(p: dict, cfg: dict, tokens: torch.Tensor,
           quant: Optional[str] = None, remat: bool = True) -> torch.Tensor:
    """Final-normed hidden states (B, S, d_model) of tokens (B, S)."""
    h = p["embed"]["table"][tokens.to(torch.int64)].float()
    seg = p["seg0"]
    for i in range(cfg["n_layers"]):
        args = (seg["norm1"]["scale"][i], seg["norm2"]["scale"][i],
                *(seg["attn"][n]["w"][i] for n in ("wq", "wk", "wv", "wo")),
                *(seg["mlp"][n]["w"][i] for n in ("gate", "up", "down")))
        if remat and torch.is_grad_enabled():
            h = checkpoint(_layer, cfg, quant, h, *args, use_reentrant=False)
        else:
            h = _layer(cfg, quant, h, *args)
    return _rms(h, p["final_norm"]["scale"])


def _rows_loss(h, table, labels, t_logits, quant, kd_grad=True):
    """(summed CE, summed KL) of a block of rows; ``kd_grad=False`` keeps
    the KL's value and drops its gradient (a planted fault)."""
    logits = _mm(h, table.T, quant)
    ce = F.cross_entropy(logits, labels, reduction="sum")
    kl = (C.kl_rows(t_logits, logits if kd_grad else logits.detach()).sum()
          if t_logits is not None else torch.zeros((), device=h.device))
    return torch.stack([ce, kl])


def step_loss(p: dict, teacher: Optional[dict], cfg: dict,
              tokens: torch.Tensor, gamma: float, quant=None,
              rows: int = 1024, kd_grad: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(CE + (γ/2)·mean KL, the KD term) of a batch (B, S + 1): inputs
    ``tokens[:, :-1]``, labels ``tokens[:, 1:]``; the teacher's logits
    without gradients.  Logit rows in blocks of ``rows``, recomputed in
    the backward."""
    x, y = tokens[:, :-1], tokens[:, 1:].reshape(-1).to(torch.int64)
    h = hidden(p, cfg, x, quant).reshape(-1, cfg["d_model"])
    t_h = None
    if teacher is not None:
        with torch.no_grad():
            t_h = hidden(teacher, cfg, x, quant).reshape(-1, cfg["d_model"])
    table = p["embed"]["table"]
    total = torch.zeros(2, device=h.device)
    for i in range(0, h.shape[0], rows):
        sl = slice(i, i + rows)
        t_logits = None
        if t_h is not None:
            with torch.no_grad():
                t_logits = _mm(t_h[sl], teacher["embed"]["table"].T, quant)
        total = total + checkpoint(_rows_loss, h[sl], table, y[sl], t_logits,
                                   quant, kd_grad, use_reentrant=False)
    n = float(h.shape[0])
    ce, kl = total[0] / n, total[1] / n
    kd = 0.5 * gamma * kl
    return ce + kd, kd


def eval_ce(p: dict, cfg: dict, tokens: torch.Tensor,
            rows: int = 1024) -> float:
    """The evaluation batch's mean next-token CE (the log of the port's
    perplexity)."""
    with torch.no_grad():
        x, y = tokens[:, :-1], tokens[:, 1:].reshape(-1).to(torch.int64)
        h = hidden(p, cfg, x).reshape(-1, cfg["d_model"])
        table = p["embed"]["table"].float()
        ce = sum(F.cross_entropy(h[i:i + rows] @ table.T,
                                 y[i:i + rows], reduction="sum")
                 for i in range(0, h.shape[0], rows))
        return float(ce / h.shape[0])


def fedgkd_rounds(init: dict, layout: dict, seed: int, cfg: dict, *,
                  rounds: int, teacher_rounds: int, clients: int,
                  batches: int, batch: int, seq: int, lr: float,
                  momentum: float, gamma: float, buffer_m: int, device,
                  quant: Optional[str] = None, half_batch: bool = False,
                  loss_scale: float = 1.0, frozen: bool = False,
                  kd_grad: bool = True) -> dict:
    """The readings of ``rounds`` rounds from ``init``: ``loss`` and ``kd``
    (rounds, batches, K) of every local step, ``grad1`` (rounds, K,
    leaves) each client's first gradient in each round as the optimizer
    takes it (its momentum after one step), ``teacher`` the teacher's change from the initial weights in
    rounds 2 to ``teacher_rounds``, ``delta`` the global model's change
    after the last round, ``eval_loss`` (rounds,).

    Every product and sum is fp32; what the configuration stores in its
    parameter dtype is rounded to it when it is stored, as a run of that
    configuration stores it: the global model, each client's parameters
    after a step and its momentum.  The teacher, a mean of stored models,
    and the aggregation's sum are fp32.  ``half_batch``, ``loss_scale``,
    ``frozen`` and ``kd_grad`` plant the faults ``resnet8.fedgkd_rounds``
    plants."""
    vocab, pdtype = cfg["vocab_size"], layouts.DTYPES[cfg["param_dtype"]]
    ev = torch.from_numpy(fdata.eval_tokens(vocab, seq)).to(device)
    glob, buffer = init, [init]
    out = {"loss": [], "kd": [], "teacher": [], "eval_loss": [],
           "grad1": []}
    for r in range(max(rounds, teacher_rounds)):
        teacher = (buffer[0] if len(buffer) == 1 else
                   C.tree_map(lambda *xs: sum(x.float() for x in xs)
                              / len(xs), *buffer))
        if r > 0:
            out["teacher"].append(C.change_norms(teacher, layout, seed))
        if r >= rounds:
            break
        toks = fdata.client_token_batches(vocab, clients, batches, batch,
                                          seq, seed + r)
        acc, losses, kds = None, [], []
        for k in range(clients):
            p, m = glob, None
            for b in range(batches):
                t = torch.from_numpy(toks[k, b]).to(device)
                if half_batch:
                    t = t[: t.shape[0] // 2]
                live = [x.detach().float().requires_grad_(True)
                        for x in C.leaves(p)]
                with torch.enable_grad():
                    loss, kd = step_loss(C.rebuild(p, live), teacher, cfg, t,
                                         gamma, quant, kd_grad=kd_grad)
                    grads = torch.autograd.grad(loss, live)
                del live
                with torch.no_grad():
                    if frozen:
                        grads = [torch.zeros_like(g) for g in grads]
                    if m is None:
                        new_m = [g.to(pdtype) for g in grads]
                        out["grad1"].append(C.leaf_norms(
                            C.rebuild(p, list(grads))))
                    else:
                        new_m = [(momentum * mt.float() + g).to(pdtype)
                                 for mt, g in zip(C.leaves(m), grads)]
                    del grads
                    m = C.rebuild(p, new_m)
                    p = C.tree_map(lambda pt, mt: (pt.float() - lr * mt.float())
                                   .to(pdtype), p, m)
                losses.append(loss.detach() * loss_scale)
                kds.append(kd.detach())
            del m
            with torch.no_grad():
                if acc is None:
                    acc = C.tree_map(lambda x: x.float() / clients, p)
                else:
                    for a, x in zip(C.leaves(acc), C.leaves(p)):
                        a.add_(x.float(), alpha=1.0 / clients)
            del p
        del teacher
        glob = C.tree_map(lambda a: a.to(pdtype), acc)
        del acc
        buffer = (buffer + [glob])[-buffer_m:]
        out["eval_loss"].append(eval_ce(glob, cfg, ev))
        # (batches, clients): the steps were taken client after client
        out["loss"].append(torch.stack(losses).reshape(clients, batches).T)
        out["kd"].append(torch.stack(kds).reshape(clients, batches).T)
    out["delta"] = C.change_norms(glob, layout, seed)
    del glob, buffer
    return {"loss": torch.stack(out["loss"]).cpu(),
            "kd": torch.stack(out["kd"]).cpu(),
            "grad1": torch.stack(out["grad1"]).reshape(
                rounds, clients, -1).cpu(),
            "teacher": torch.stack(out["teacher"]).cpu(),
            "delta": out["delta"].cpu(),
            "eval_loss": torch.tensor(out["eval_loss"])}


def readings(init: dict, layout: dict, seed: int, cfg: dict, traffic: dict,
             rounds: int, teacher_rounds: int, device,
             precision: str = "fp32", fault: Optional[str] = None) -> dict:
    """``fedgkd_rounds`` on the cell's settings in ``precision`` ("fp32",
    or "fp8" for the control), with an optional planted ``fault`` (those of
    ``resnet8.readings``)."""
    with C.precision("fp32"):
        return fedgkd_rounds(
            init, layout, seed, cfg, rounds=rounds,
            teacher_rounds=teacher_rounds, clients=traffic["clients"],
            batches=traffic["batches_per_round"], batch=traffic["batch"],
            seq=traffic["seq"], lr=cfg["lr"], momentum=cfg["momentum"],
            gamma=0.0 if fault == "kd_off" else traffic["gamma"],
            buffer_m=traffic["buffer_m"],
            device=device, quant="fp8" if precision == "fp8" else None,
            half_batch=fault == "half_batch",
            loss_scale=1.01 if fault == "altered_loss" else 1.0,
            frozen=fault == "unchanged", kd_grad=fault != "kd_dropped")
