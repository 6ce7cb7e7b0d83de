"""The LM steps: the FedGKD train step, serving and prefill.

The port of ``repro.launch.steps``.  A client's local step minimises
(paper Eq. 4)

    L = CE(student(x), y) + aux [+ λ·CE_MTP] + (γ/2)·KL(teacher ‖ student)

(aux the MoE layers' load-balance loss, 0 without them)

with kd_mode "none" (the FedAvg local step), "teacher" (a full teacher
forward each step, under ``torch.no_grad``) or "cached_topk" (the batch
carries the teacher's top-K logits and their vocabulary ids,
``teacher_topk_vals`` and ``teacher_topk_idx`` (B, S_text, K): the KL of
the teacher's distribution restricted and renormalised to its top K,
``kd_topk_kl``, amortising the teacher's forward out of the step).  An
encoder-decoder's batch carries ``enc_embeddings`` (the encoder's input,
run through ``transformer.encode`` in every forward, the teacher's
included), a frontend model's ``frontend_embeddings`` (a prefix of
``frontend_seq`` positions before the text); the labels are the text's,
aligned to its last positions (``text_offset``), so the prefix carries no
CE, no MTP and no ``cached_topk`` term; under "teacher" the KL covers
every position, the prefix's too, as in the reference.  With
``cfg.mtp_depth`` the MTP head predicts the labels shifted by one (the
last position's target padded with -1, which the CE ignores) from the
trunk's hidden states, weighted by ``mtp_weight`` (λ, 0.3 as in the
reference); the reference runs the trunk a second time for it, the port
reuses the hidden states of the forward, which are the same values.  The next-token CE takes its
row logsumexp from ``kernels.kd_kl.ops.row_logsumexp`` (B6) and the KL
goes through ``core.distillation.kl_divergence`` (B1/B2): the CUDA
kernels on a card, their plain versions on the CPU.  ``make_serve_step``
is one token of decode over the cache (plain PyTorch, as in the
reference) and ``make_prefill_step`` an inference forward without
gradients, of every position or of the last only.
``make_aggregate_step`` is the server's weighted mean of the sharded
round (``launch.train.run_sharded``).  The encoder-decoder and frontend
models are driven through these steps: the reference's ``run_serial``
and ``ServeLoop`` feed tokens only.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import distillation as D
from repro_torch.core.server import weighted_average
from repro_torch.kernels.kd_kl.ops import row_logsumexp
from repro_torch.models import frontends, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer, apply_updates, sgd
from repro_torch.tree import tree_flatten, tree_map

KD_MODES = ("none", "teacher", "cached_topk")


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     text_offset: int = 0) -> torch.Tensor:
    """Next-token CE: the mean over labels other than -1 of
    lse(logits) − logits[label].  logits (B, S_total, V); labels (B,
    S_text), aligned to the last S_text positions: the first
    ``text_offset`` (a frontend prefix) carry no loss.

    The function the reference computes through ``log_softmax``
    (``core.distillation.cross_entropy`` with ``ignore_index=-1``), with
    the row logsumexp taken by ``row_logsumexp`` so that no (B·S, V)
    log-probability tensor is written."""
    if text_offset:
        logits = logits[:, text_offset:]
    v = logits.shape[-1]
    flat = logits.reshape(-1, v)
    labels = labels.reshape(-1).to(torch.int64)
    valid = labels != -1
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    at_label = torch.gather(flat, 1, safe[:, None])[:, 0].to(torch.float32)
    nll = (row_logsumexp(flat) - at_label) * valid.to(torch.float32)
    return nll.sum() / torch.clamp(valid.to(torch.float32).sum(), min=1.0)


def kd_topk_kl(topk_vals: torch.Tensor, topk_idx: torch.Tensor,
               student_logits: torch.Tensor) -> torch.Tensor:
    """Sparse KD: KL(p̂_T ‖ p_S) at each position, p̂_T the teacher's
    distribution restricted to its top K and renormalised.  topk_vals and
    topk_idx (..., K): the teacher's logits and their vocabulary ids;
    student_logits (..., V).  Everything in fp32; the student's row
    logsumexp from ``row_logsumexp`` (B6)."""
    vals = topk_vals.to(torch.float32)
    p_t = torch.softmax(vals, dim=-1)
    logp_t = torch.log_softmax(vals, dim=-1)
    s = student_logits.to(torch.float32)
    lse_s = row_logsumexp(s.reshape(-1, s.shape[-1])).reshape(s.shape[:-1])
    ls_at = torch.gather(s, -1, topk_idx.to(torch.int64))
    logp_s = ls_at - lse_s[..., None]
    return torch.sum(p_t * (logp_t - logp_s), dim=-1)


def _inputs(params, cfg: ModelConfig, batch: dict) -> dict:
    """The decoder's other inputs: the encoder's output (``encode`` of
    ``enc_embeddings``) or the frontend's prefix."""
    if cfg.enc_layers:
        return {"enc_out": transformer.encode(params, cfg,
                                              batch["enc_embeddings"])}
    if cfg.frontend:
        return {"prefix_embeddings": batch["frontend_embeddings"]}
    return {}


def _forward(params, cfg: ModelConfig, batch: dict):
    return transformer.forward(params, cfg, batch["tokens"],
                               **_inputs(params, cfg, batch))


def text_offset(cfg: ModelConfig) -> int:
    """The prefix positions before the text: a frontend model's
    ``frontend_seq`` (its frontend's default where 0), else 0."""
    if cfg.frontend and not cfg.enc_layers:
        return cfg.frontend_seq or frontends.frontend_seq(cfg.frontend)
    return 0


def make_loss_fn(cfg: ModelConfig, *, kd_mode: str = "teacher",
                 gamma: float = 0.2, kd_temperature: float = 1.0,
                 mtp_weight: float = 0.3):
    """loss(params, teacher_params, batch) -> (loss, metrics): ``ce``,
    ``aux``, ``mtp_ce`` with an MTP head and ``kd`` under FedGKD (either
    KD mode)."""
    if kd_mode not in KD_MODES:
        raise ValueError(f"kd_mode {kd_mode!r} not in {KD_MODES}")
    offset = text_offset(cfg)

    def loss_fn(params, teacher_params, batch):
        labels = batch["labels"]
        h, aux = transformer.hidden_states(params, cfg, batch["tokens"],
                                           **_inputs(params, cfg, batch))
        logits = transformer.logits_from_hidden(params, cfg, h)
        ce = lm_cross_entropy(logits, labels, offset)
        loss = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp_depth:
            mtp = transformer.mtp_logits(params, cfg, h[:, offset:], labels)
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
        elif kd_mode == "cached_topk":
            kl = kd_topk_kl(batch["teacher_topk_vals"],
                            batch["teacher_topk_idx"], logits[:, offset:])
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
    metrics); ``teacher_params=()`` unless kd_mode is "teacher".  The metrics
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
            # a leaf the loss never reads (a run of no layers) gets a zero
            # gradient, as under jax.grad
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
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
    tensor.  An encoder-decoder's batch is encoded first; a frontend
    model's prefix comes before its tokens."""

    def step(params, batch):
        with torch.no_grad():
            if last_only:
                h, _ = transformer.hidden_states(
                    params, cfg, batch["tokens"],
                    **_inputs(params, cfg, batch))
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
