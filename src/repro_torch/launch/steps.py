"""The LM steps: the FedGKD train step, serving and prefill.

The port of ``repro.launch.steps``.  A client's local step minimises
(paper Eq. 4)

    L = CE(student(x), y) + aux [+ λ·CE_MTP] + (γ/2)·KL(teacher ‖ student)

(aux the MoE layers' load-balance loss, 0 without them)

with kd_mode "none" (the FedAvg local step) or "teacher" (a full teacher
forward each step, under ``torch.no_grad``).  With ``cfg.mtp_depth`` the
MTP head predicts the labels shifted by one (the last position's target
padded with -1, which the CE ignores) from the trunk's hidden states,
weighted by ``mtp_weight`` (λ, 0.3 as in the reference); the reference
runs the trunk a second time for it, the port reuses the hidden states of
the forward, which are the same values.  The next-token CE takes its
row logsumexp from ``kernels.kd_kl.ops.row_logsumexp`` (B6) and the KL
goes through ``core.distillation.kl_divergence`` (B1/B2): the CUDA
kernels on a card, their plain versions on the CPU.  ``make_serve_step``
is one token of decode over the cache (plain PyTorch, as in the
reference) and ``make_prefill_step`` an inference forward without
gradients, of every position or of the last only.
``make_aggregate_step`` is the server's weighted mean of the sharded
round (``launch.train.run_sharded``).

Not ported yet: kd_mode "cached_topk", frontends and encoder-decoder
inputs (ROADMAP A15.7).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import distillation as D
from repro_torch.core.server import weighted_average
from repro_torch.kernels.kd_kl.ops import row_logsumexp
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer, apply_updates, sgd
from repro_torch.tree import tree_flatten, tree_map

KD_MODES = ("none", "teacher")


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token CE: the mean over labels other than -1 of
    lse(logits) − logits[label].  logits (B, S, V); labels (B, S).

    The function the reference computes through ``log_softmax``
    (``core.distillation.cross_entropy`` with ``ignore_index=-1``), with
    the row logsumexp taken by ``row_logsumexp`` so that no (B·S, V)
    log-probability tensor is written.  (The reference's ``text_offset``
    serves frontend prefixes, which are not ported: ROADMAP A15.7.)"""
    v = logits.shape[-1]
    flat = logits.reshape(-1, v)
    labels = labels.reshape(-1).to(torch.int64)
    valid = labels != -1
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    at_label = torch.gather(flat, 1, safe[:, None])[:, 0].to(torch.float32)
    nll = (row_logsumexp(flat) - at_label) * valid.to(torch.float32)
    return nll.sum() / torch.clamp(valid.to(torch.float32).sum(), min=1.0)


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _forward(params, cfg: ModelConfig, batch: dict):
    return transformer.forward(params, cfg, batch["tokens"])


def make_loss_fn(cfg: ModelConfig, *, kd_mode: str = "teacher",
                 gamma: float = 0.2, kd_temperature: float = 1.0,
                 mtp_weight: float = 0.3):
    """loss(params, teacher_params, batch) -> (loss, metrics): ``ce``,
    ``aux``, ``mtp_ce`` with an MTP head and ``kd`` under FedGKD."""
    if kd_mode == "cached_topk":
        _unported("kd_mode='cached_topk'", "A15.7")
    if kd_mode not in KD_MODES:
        raise ValueError(f"kd_mode {kd_mode!r} not in {KD_MODES}")

    def loss_fn(params, teacher_params, batch):
        labels = batch["labels"]
        h, aux = transformer.hidden_states(params, cfg, batch["tokens"])
        logits = transformer.logits_from_hidden(params, cfg, h)
        ce = lm_cross_entropy(logits, labels)
        loss = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp_depth:
            mtp = transformer.mtp_logits(params, cfg, h, labels)
            targets = torch.cat([labels[:, 1:],
                                 torch.full_like(labels[:, :1], -1)], dim=1)
            mtp_ce = lm_cross_entropy(mtp, targets)
            loss = loss + mtp_weight * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        if kd_mode == "teacher":
            with torch.no_grad():
                t_logits, _ = _forward(teacher_params, cfg, batch)
            kl = D.kl_divergence(t_logits, logits, kd_temperature)
            kd = 0.5 * gamma * torch.mean(kl)
            loss = loss + kd
            metrics["kd"] = kd
        return loss, metrics

    return loss_fn


def make_train_step(cfg: ModelConfig, opt: Optional[Optimizer] = None, *,
                    kd_mode: str = "teacher", gamma: float = 0.2,
                    kd_temperature: float = 1.0, lr: float = 0.05,
                    mtp_weight: float = 0.3):
    """step(params, teacher_params, opt_state, batch) -> (params, opt_state,
    metrics); ``teacher_params=()`` when kd_mode is "none".  The metrics
    come back detached, on the params' device."""
    opt = opt or sgd(momentum=0.9, weight_decay=1e-5)
    loss_fn = make_loss_fn(cfg, kd_mode=kd_mode, gamma=gamma,
                           kd_temperature=kd_temperature,
                           mtp_weight=mtp_weight)

    def step(params, teacher_params, opt_state, batch):
        leaves, rebuild = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, metrics = loss_fn(rebuild(live), teacher_params, batch)
            grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            updates, opt_state = opt.update(rebuild(list(grads)), opt_state,
                                            params, lr)
            metrics = tree_map(torch.Tensor.detach, {**metrics, "loss": loss})
            return apply_updates(params, updates), opt_state, metrics

    return step


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens [, enc_out]) -> (logits, cache)."""

    def step(params, cache, tokens, enc_out=None):
        with torch.no_grad():
            return transformer.decode_step(params, cfg, tokens, cache,
                                           enc_out=enc_out)

    return step


def make_prefill_step(cfg: ModelConfig, *, last_only: bool = False):
    """prefill(params, batch) -> logits: an inference forward, no grads.

    ``last_only`` returns only the final position's logits (B, 1, V), what
    a serving stack needs before decode, and never writes the (B, S, V)
    tensor."""

    def step(params, batch):
        with torch.no_grad():
            if last_only:
                h, _ = transformer.hidden_states(params, cfg, batch["tokens"])
                return transformer.logits_from_hidden(params, cfg, h[:, -1:])
            logits, _ = _forward(params, cfg, batch)
            return logits

    return step


def make_aggregate_step():
    """aggregate(params_list, weights) -> the weighted mean of the clients'
    params (Alg. 1 line 14) on the first client's device.

    The reference runs it under ``shard_map`` as one ``psum`` over a mesh
    axis, each client's params on its own device.  PyTorch has no psum
    inside a program, so the port gathers the per-client trees (each on
    its client's device) to the first client's device and takes the
    server's ``weighted_average`` there: each term ``p · (w / total)`` in
    fp32 (JAX promotes a bf16 leaf times an fp32 weight), summed in client
    order and cast back to p's dtype, as the reference's."""

    def aggregate(params_list: list, weights) -> dict:
        if len(weights) != len(params_list):
            raise ValueError(f"{len(params_list)} clients, "
                             f"{len(weights)} weights")
        first = tree_flatten(params_list[0])[0][0].device
        return weighted_average(
            [tree_map(lambda t: t.to(first), p) for p in params_list],
            [float(w) for w in weights])

    return aggregate
