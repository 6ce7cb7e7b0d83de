"""Federated algorithms on the main path: FedAvg and FedGKD (the paper's).

The port of ``Algorithm`` and ``FedGKD`` from ``repro.core.algorithms``;
the other baselines are queued (ROADMAP A8b).  The FL loop is
algorithm-agnostic: an algorithm supplies its server state, the round's
broadcast payload, an optional round-constant precompute stage, and its
local loss in two forms — ``loss_fn`` for one client and
``batched_loss_fn`` for a client-stacked cohort.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import distillation as D
from repro_torch.core.modelzoo import ModelBundle
from repro_torch.core.server import ModelBuffer, weighted_average


class Algorithm:
    """Base: FedAvg.  Subclasses override the regularizer hooks.

    ``mask`` is a per-example weight vector (padded examples weigh 0);
    ``mask=None`` means all ones.
    """

    name = "fedavg"
    needs_projection_head = False
    supports_vmap = True      # False would force the sequential executor

    def __init__(self, **kw):
        self.hp = kw

    # -- server ------------------------------------------------------------
    def init_server(self, global_params: Any, model: ModelBundle,
                    num_classes: int) -> dict:
        return {"global": global_params, "round": 0}

    def round_payload(self, server: dict) -> Any:
        """Broadcast content beyond the global weights."""
        return ()

    def server_update(self, server: dict, uploads: list[dict],
                      weights: list[float], model: ModelBundle,
                      val_batch=None, n_clients: int | None = None) -> dict:
        new_global = weighted_average([u["params"] for u in uploads], weights)
        server = dict(server)
        server["global"] = new_global
        server["round"] += 1
        return server

    # -- client ------------------------------------------------------------
    def init_client_state(self, client_id: int, global_params: Any) -> Any:
        return ()

    def precompute_aux(self, model: ModelBundle, payload: Any, x: Any,
                       y: Any, mask: Any) -> Any:
        """Round-constant per-example tensors, computed once per round on
        each client's full shard outside autograd; ``None`` (the default)
        means the algorithm has no precompute stage.  Outputs have leading
        axis ``len(x)``; executors gather them per batch as ``aux``."""
        return None

    def loss_fn(self, model: ModelBundle):
        """``loss(params, payload, client_state, x, y, mask=None, aux=None)
        -> (loss, metrics)`` for one client."""

        def loss(params, payload, client_state, x, y, mask=None, aux=None):
            logits = model.apply(params, x)
            return D.cross_entropy(logits, y, mask=mask), {}

        return loss

    def batched_loss_fn(self, model: ModelBundle):
        """Client-stacked ``loss_fn``: ``loss(params, payload, states, x, y,
        mask, aux) -> (total, per_client)`` with params ``(K, ...)`` and x
        ``(K, B, ...)``.  ``total`` is the sum of the per-client losses;
        client parameters are disjoint, so its gradient is the per-client
        gradients.  ``None`` when a subclass overrides ``loss_fn`` without
        a stacked form."""
        if type(self).loss_fn is not Algorithm.loss_fn:
            return None

        def loss(params, payload, client_states, x, y, mask, aux=None):
            per = D.cross_entropy_per_client(model.apply(params, x), y,
                                             mask=mask)
            return torch.sum(per), per

        return loss


class FedGKD(Algorithm):
    """The paper's method (Eq. 4): teacher = mean of the last M globals."""

    name = "fedgkd"

    def __init__(self, gamma: float = 0.2, buffer_m: int = 5,
                 loss_type: str = "kl", temperature: float = 1.0, **kw):
        if loss_type != "kl":
            raise NotImplementedError(
                f"FedGKD loss_type={loss_type!r} (the Table 9 ablation) is "
                f"not ported yet (ROADMAP A8b)")
        super().__init__(gamma=gamma, buffer_m=buffer_m, loss_type=loss_type,
                         **kw)
        self.gamma, self.buffer_m = gamma, buffer_m
        self.loss_type, self.temperature = loss_type, temperature

    def init_server(self, global_params, model, num_classes):
        buf = ModelBuffer(self.buffer_m)
        buf.push(global_params)
        return {"global": global_params, "round": 0, "buffer": buf}

    def round_payload(self, server):
        return {"teacher": server["buffer"].fused()}

    def precompute_aux(self, model, payload, x, y, mask):
        # the teacher is frozen for the round (Eq. 4): its logits are
        # constants per example, computed once per shard
        del y, mask
        with torch.no_grad():
            return {"t_logits": model.apply(payload["teacher"], x)
                    .to(torch.float32)}

    def loss_fn(self, model):
        gamma, temp = self.gamma, self.temperature

        def loss(params, payload, client_state, x, y, mask=None, aux=None):
            logits = model.apply(params, x)
            if aux is not None:
                t_logits = aux["t_logits"]
            else:
                with torch.no_grad():
                    t_logits = model.apply(payload["teacher"], x)
            ce = D.cross_entropy(logits, y, mask=mask)
            kd = D.kd_loss_kl(t_logits.detach(), logits, gamma, temp,
                              mask=mask)
            return ce + kd, {"kd": kd}

        return loss

    def batched_loss_fn(self, model):
        if type(self).loss_fn is not FedGKD.loss_fn:
            return None
        gamma, temp = self.gamma, self.temperature

        def loss(params, payload, client_states, x, y, mask, aux=None):
            logits = model.apply(params, x)                   # (K, B, C)
            if aux is not None:
                t_logits = aux["t_logits"]
            else:
                # the teacher is ONE shared model: fold the cohort into the
                # batch axis for a single-model forward, then unfold
                k, b = x.shape[0], x.shape[1]
                with torch.no_grad():
                    t_logits = model.apply(
                        payload["teacher"],
                        x.reshape((k * b,) + tuple(x.shape[2:]))
                    ).reshape(k, b, -1)
            per = D.cross_entropy_per_client(logits, y, mask=mask)
            kd = 0.5 * gamma * D.masked_mean_per_client(
                D.kl_divergence(t_logits.detach(), logits, temp), mask)
            per = per + kd
            return torch.sum(per), per

        return loss

    def server_update(self, server, uploads, weights, model, val_batch=None,
                      n_clients=None):
        server = super().server_update(server, uploads, weights, model,
                                       val_batch, n_clients)
        server["buffer"].push(server["global"])
        return server


_ALGOS = {"fedavg": Algorithm, "fedgkd": FedGKD}


def make(name: str, **kw) -> Algorithm:
    if name not in _ALGOS:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet (ROADMAP A8b); the port "
            f"has {available()}")
    return _ALGOS[name](**kw)


def available() -> list[str]:
    return sorted(_ALGOS)
