"""Client side: one local step, one client's masked pass, and the
whole-cohort local update.

The port of ``repro.core.client``'s ``make_step``, ``make_local_update``
and ``make_batched_local_update``.  ``make_step`` is one autograd pass of
an algorithm's loss followed by the optimizer update; the sequential
executor runs one per batch of one client (``mask=None``: every example
counts).  ``make_local_update`` is one client's whole pass over a stacked
``(S, B, ...)`` batch tensor with the two masks below, written with
``torch.func`` so that the executor's vmapped round body can
``torch.func.vmap`` it over a cohort.

For client-batched models the global params are broadcast to a
client-stacked ``(K, ...)`` copy, and each local step is one such step on
the summed per-client losses (``Algorithm.batched_loss_fn``).  Inputs
carry a step axis: ``xs`` (K, S, B, ...), with two masks:

    ex_mask   (K, S, B)   zero weight for examples padded onto a ragged
                          batch — they add nothing to loss or gradients
    step_mask (K, S)      False for steps padded onto a client with fewer
                          batches than the cohort's longest — the whole
                          step leaves THAT client's params and optimizer
                          state exactly as they were

``aux`` is the per-step precompute dict (leaves (K, S, B, ...)) or ``()``
when there is none; the loss then receives ``aux=None``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.func import grad_and_value

from repro_torch import trace
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.tree import tree_flatten, tree_map


def _aux_or_none(aux: Any) -> Any:
    """The executor convention: the empty tuple means no aux."""
    return None if isinstance(aux, tuple) and len(aux) == 0 else aux


def make_step(loss_fn: Callable, opt: Optimizer) -> Callable:
    """One step: ``step(params, opt_state, payload, client_state, x, y,
    mask, aux, lr) -> (params, opt_state, loss, metrics)``, where
    ``loss_fn(params, payload, client_state, x, y, mask, aux) -> (loss,
    metrics)``.  Pass ``aux=()`` when there is no precompute.  The loss
    and metrics come back detached, on the params' device."""

    def step(params, opt_state, payload, client_state, x, y, mask, aux, lr):
        leaves, rebuild = tree_flatten(params)
        live_leaves = [p.detach().requires_grad_(True) for p in leaves]
        with trace.span("step"):
            with torch.enable_grad():
                with trace.span("step_forward"):
                    loss, metrics = loss_fn(rebuild(live_leaves), payload,
                                            client_state, x, y, mask,
                                            _aux_or_none(aux))
                with trace.span("step_backward"):
                    grads = torch.autograd.grad(loss, live_leaves)
            with torch.no_grad(), trace.span("step_optimizer"):
                updates, opt_state = opt.update(rebuild(list(grads)),
                                                opt_state, params, lr)
                new_params = apply_updates(params, updates)
        return (new_params, opt_state, loss.detach(),
                tree_map(torch.Tensor.detach, metrics))

    return step


def make_local_update(loss_fn: Callable, opt: Optimizer) -> Callable:
    """One client's masked pass: ``local_update(params, payload,
    client_state, xs (S, B, ...), ys, ex_mask (S, B), aux, step_mask (S,),
    lr) -> (new_params, mean_loss)``.

    Each step is ``torch.func.grad_and_value`` of ``loss_fn`` over the
    params, then the optimizer; a step whose ``step_mask`` is False leaves
    params and optimizer state bit-identical (``torch.where``), and the
    loss is averaged over the live steps.  ``aux`` is the per-step dict
    (leaves (S, B, ...)) or ``()``.  Pure in its tensor arguments, so it
    composes with ``torch.func.vmap`` (the executor's vmapped round body).
    """

    def local_update(params: Any, payload: Any, client_state: Any,
                     xs: torch.Tensor, ys: torch.Tensor,
                     ex_mask: torch.Tensor, aux: Any,
                     step_mask: torch.Tensor, lr: float):
        opt_state = opt.init(params)
        losses = []
        for s in range(xs.shape[0]):
            aux_s = _aux_or_none(tree_map(lambda l: l[s], aux))
            grads, (loss, _) = grad_and_value(
                lambda p: loss_fn(p, payload, client_state, xs[s], ys[s],
                                  ex_mask[s], aux_s), has_aux=True)(params)
            updates, o2 = opt.update(grads, opt_state, params, lr)
            p2 = apply_updates(params, updates)
            live = step_mask[s]
            params = tree_map(lambda new, old: torch.where(live, new, old),
                              p2, params)
            opt_state = tree_map(lambda new, old: torch.where(live, new, old),
                                 o2, opt_state)
            losses.append(torch.where(live, loss, torch.zeros_like(loss)))
        denom = torch.clamp(step_mask.to(torch.float32).sum(), min=1.0)
        mean_loss = (torch.stack(losses).sum() / denom if losses
                     else torch.zeros((), device=xs.device))
        return params, mean_loss

    return local_update


def make_batched_local_update(batched_loss_fn: Callable,
                              opt: Optimizer) -> Callable:
    """Return ``local_update(global_params, payload, states, xs, ys,
    ex_mask, aux, step_mask, lr) -> (params (K, ...), mean_loss (K,))``.

    ``mean_loss[k]`` is client k's loss averaged over its live steps.
    """
    step = make_step(batched_loss_fn, opt)      # metrics: per-client losses

    def local_update(global_params: Any, payload: Any, states: Any,
                     xs: torch.Tensor, ys: torch.Tensor,
                     ex_mask: torch.Tensor, aux: Any,
                     step_mask: torch.Tensor, lr: float):
        k, s = xs.shape[0], xs.shape[1]
        params = tree_map(lambda l: l.detach().expand((k,) + tuple(l.shape))
                          .clone(), global_params)
        opt_state = opt.init(params, lead=(k,))
        losses = []
        for i in range(s):
            aux_i = tree_map(lambda l: l[:, i], aux)
            live = step_mask[:, i]
            p2, o2, _, per = step(params, opt_state, payload, states,
                                  xs[:, i], ys[:, i], ex_mask[:, i], aux_i, lr)

            def keep(new, old):
                return torch.where(
                    live.reshape((k,) + (1,) * (new.ndim - 1)), new, old)

            params = tree_map(keep, p2, params)
            opt_state = tree_map(keep, o2, opt_state)
            losses.append(torch.where(live, per, torch.zeros_like(per)))
        denom = torch.clamp(step_mask.to(torch.float32).sum(dim=1), min=1.0)
        mean_loss = (torch.stack(losses).sum(dim=0) / denom if losses
                     else torch.zeros(k, device=xs.device))
        return params, mean_loss

    return local_update
