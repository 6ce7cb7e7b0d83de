"""All federated algorithms of the paper's evaluation (Tab. 1 / §5.1).

The port of ``repro.core.algorithms``:

    fedavg        McMahan et al. 2017 — plain weighted averaging
    fedprox       Li et al. 2018 — + (μ/2)‖w − w_t‖² proximal term
    moon          Li et al. 2021 — model-contrastive loss (projection head)
    feddistill+   Seo et al. 2020 (+ param sharing) — per-label global logits
    fedgen        Zhu et al. 2021 — server-side feature generator
    fedgkd        THE PAPER — fused historical-global-ensemble teacher, Eq. 4
    fedgkd-vote   Eq. 5 — M teachers with validation-softmax coefficients
    fedgkd+       fedgkd on the projection-head model (vs MOON)
    scaffold      Karimireddy et al. 2019 — control variates
    feddyn        Acar et al. 2020 — dynamic regularization

The FL loop is algorithm-agnostic: an algorithm supplies its server state,
the round's broadcast payload, an optional round-constant precompute stage,
its local loss in two forms — ``loss_fn`` for one client and
``batched_loss_fn`` for a client-stacked cohort — and the client hooks
``client_finalize`` (extra uploads) and ``update_client_state``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import distillation as D
from repro_torch.core.modelzoo import ModelBundle
from repro_torch.core.server import (ModelBuffer, first_nonfinite_path,
                                     weighted_average)
from repro_torch.models import layers
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


def _one_hot(y: torch.Tensor, c: int) -> torch.Tensor:
    """fp32 one-hot rows; ``F.one_hot`` checks its labels' range with a
    read back, which ``torch.func.vmap`` cannot do."""
    return (y[..., None] == torch.arange(c, device=y.device)).to(torch.float32)


class Algorithm:
    """Base: FedAvg.  Subclasses override the regularizer hooks.

    ``mask`` is a per-example weight vector (padded examples weigh 0);
    ``mask=None`` means all ones.
    """

    name = "fedavg"
    needs_projection_head = False
    comm_multiplier = 1.0     # download cost relative to FedAvg
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
        """Aggregate the round.  ``n_clients`` is the total client count
        (the cohort is only ``len(uploads)``)."""
        new_global = weighted_average([u["params"] for u in uploads], weights)
        server = dict(server)
        server["global"] = new_global
        server["round"] += 1
        return server

    def absorb_stale(self, server: dict, uploads: list[dict],
                     staleness: list[float], weights: list[float],
                     model: ModelBundle | None = None,
                     val_batch=None) -> dict:
        """What to do with stale arrivals beyond down-weighting them: the
        buffered async server calls this under the ``"fedgkd"`` staleness
        scheme after ``server_update``, with the whole buffer, each
        update's staleness and its data weight n_k.  The base discards
        them; KD algorithms absorb them into the teacher buffer."""
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

    def precompute_parts(self, payload: Any):
        """``None``, or ``(keys, get_part)``: ``precompute_aux`` split into
        parts, ``keys[m]`` the version id of part m's payload slice (kept
        across rounds while the slice is unchanged) and ``get_part(m)``
        that slice.  The vmap executor then keeps each part's
        ``precompute_part`` output per client across rounds
        (``RoundContext.aux_cache``), computes only the parts with new
        keys, and folds them with ``precompute_combine``."""
        return None

    def precompute_part(self, model: ModelBundle, part_payload: Any,
                        x: Any) -> torch.Tensor:
        """Per-example output of one cacheable part: (N, ...)."""
        raise NotImplementedError

    def precompute_combine(self, payload: Any, parts: torch.Tensor, x: Any,
                           y: Any, mask: Any) -> Any:
        """Fold stacked part outputs (n_parts, N, ...) into the aux dict;
        equals ``precompute_aux`` on the same shard."""
        raise NotImplementedError

    def host_step_inputs(self, payload: Any, ys: torch.Tensor,
                         mask: torch.Tensor) -> Optional[dict]:
        """Per-step inputs the loss would draw from values on the device,
        drawn on the host before the vmapped round body (a value read back
        inside ``torch.func.vmap`` is an error): a dict of leaves (K, S, B,
        ...) that the executor adds to ``aux``, or ``None`` (the default).
        ``ys`` (K, S, B) and ``mask`` (K, S, B) are the round's padded
        labels and example mask, on the CPU."""
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

    def client_finalize(self, model: ModelBundle, params: Any, x: Any,
                        y: Any, mask: Any, payload: Any) -> dict:
        """Extra uploads beyond the trained weights, from the client's full
        shard ``x``, ``y`` with per-example weights ``mask``."""
        return {}

    def update_client_state(self, client_state: Any, params: Any,
                            payload: Any = None) -> Any:
        return client_state


# ---------------------------------------------------------------------------

class FedProx(Algorithm):
    name = "fedprox"

    def __init__(self, mu: float = 0.01, **kw):
        super().__init__(mu=mu, **kw)
        self.mu = mu

    def round_payload(self, server):
        return {"anchor": server["global"]}

    def loss_fn(self, model):
        mu = self.mu

        def loss(params, payload, client_state, x, y, mask=None, aux=None):
            logits = model.apply(params, x)
            prox = 0.5 * mu * D.param_sq_dist(params, payload["anchor"])
            return D.cross_entropy(logits, y, mask=mask) + prox, {}

        return loss

    def batched_loss_fn(self, model):
        if type(self).loss_fn is not FedProx.loss_fn:
            return None
        mu = self.mu

        def loss(params, payload, client_states, x, y, mask, aux=None):
            per = D.cross_entropy_per_client(model.apply(params, x), y,
                                             mask=mask)
            per = per + 0.5 * mu * D.param_sq_dist_per_client(
                params, payload["anchor"])
            return torch.sum(per), per

        return loss


# ---------------------------------------------------------------------------

class FedGKD(Algorithm):
    """The paper's method (Eq. 4): teacher = mean of the last M globals."""

    name = "fedgkd"

    def __init__(self, gamma: float = 0.2, buffer_m: int = 5,
                 loss_type: str = "kl", temperature: float = 1.0, **kw):
        super().__init__(gamma=gamma, buffer_m=buffer_m, loss_type=loss_type,
                         **kw)
        self.gamma, self.buffer_m = gamma, buffer_m
        self.loss_type, self.temperature = loss_type, temperature

    @property
    def comm_multiplier(self):
        return 2.0 if self.buffer_m > 1 else 1.0

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
        gamma, ltype, temp = self.gamma, self.loss_type, self.temperature

        def loss(params, payload, client_state, x, y, mask=None, aux=None):
            logits = model.apply(params, x)
            if aux is not None:
                t_logits = aux["t_logits"]
            else:
                with torch.no_grad():
                    t_logits = model.apply(payload["teacher"], x)
            t_logits = t_logits.detach()
            ce = D.cross_entropy(logits, y, mask=mask)
            if ltype == "mse":
                kd = D.kd_loss_mse(t_logits, logits, gamma, mask=mask)
            else:
                kd = D.kd_loss_kl(t_logits, logits, gamma, temp, mask=mask)
            return ce + kd, {"kd": kd}

        return loss

    def batched_loss_fn(self, model):
        if type(self).loss_fn is not FedGKD.loss_fn:
            return None
        gamma, ltype, temp = self.gamma, self.loss_type, self.temperature

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
            t_logits = t_logits.detach()
            per = D.cross_entropy_per_client(logits, y, mask=mask)
            if ltype == "mse":
                d = t_logits.to(torch.float32) - logits.to(torch.float32)
                kd = 0.5 * gamma * D.masked_mean_per_client(
                    torch.sum(torch.square(d), dim=-1), mask)
            else:
                kd = 0.5 * gamma * D.masked_mean_per_client(
                    D.kl_divergence(t_logits, logits, temp), mask)
            per = per + kd
            return torch.sum(per), per

        return loss

    def server_update(self, server, uploads, weights, model, val_batch=None,
                      n_clients=None):
        server = super().server_update(server, uploads, weights, model,
                                       val_batch, n_clients)
        server["buffer"].push(server["global"])
        return server

    def absorb_stale(self, server, uploads, staleness, weights, model=None,
                     val_batch=None):
        """Late arrivals join the teacher ensemble: the stale client models
        are fused by data weight into ONE buffer entry an aggregation, so
        the buffer's version bumps once and the part caches recompute one
        part.  A non-finite stale model never becomes a teacher (it is
        skipped), nor does a fused result bitwise equal to the head
        (``ModelBuffer.push`` refuses it)."""
        stale = [(u["params"], w) for u, s, w in
                 zip(uploads, staleness, weights) if s > 0]
        stale = [(p, w) for p, w in stale if first_nonfinite_path(p) is None]
        if not stale:
            return server
        server["buffer"].push(weighted_average([p for p, _ in stale],
                                               [w for _, w in stale]))
        return server


class FedGKDPlus(FedGKD):
    """FedGKD on the projection-head model (the paper's MOON comparison)."""

    name = "fedgkd+"
    needs_projection_head = True


# ---------------------------------------------------------------------------

class FedGKDVote(FedGKD):
    """Eq. 5: all M buffered teachers, γ_m from a validation-loss softmax.

    The payload stacks the M teachers on a leading axis; early rounds pad
    with the newest model at γ = 0.
    """

    name = "fedgkd-vote"

    def __init__(self, gamma: float = 0.2, buffer_m: int = 5, lam: float = 0.1,
                 **kw):
        super().__init__(gamma=gamma, buffer_m=buffer_m, **kw)
        self.lam = lam

    @property
    def comm_multiplier(self):
        return float(self.buffer_m)

    def init_server(self, global_params, model, num_classes):
        s = super().init_server(global_params, model, num_classes)
        s["val_losses"] = [0.0]
        return s

    def round_payload(self, server):
        models = server["buffer"].models            # newest first, len m<=M
        versions = server["buffer"].versions
        m_avail = len(models)
        gammas = D.vote_coefficients(server["val_losses"][:m_avail],
                                     lam=self.lam)
        pad = self.buffer_m - m_avail
        stacked = tree_map(lambda *xs: torch.stack(list(xs) + [xs[0]] * pad),
                           *models)
        device = tree_leaves(models[0])[0].device
        gvec = torch.tensor(gammas + [0.0] * pad, dtype=torch.float32,
                            device=device)
        # versions pad with the newest id, as the teachers do: a padded
        # slot is the same model, so its logits are too
        vvec = np.asarray(versions + [versions[0]] * pad, np.int32)
        return {"teachers": stacked, "gammas": gvec, "teacher_versions": vvec}

    @staticmethod
    def _teacher(payload, m):
        return tree_map(lambda l: l[m], payload["teachers"])

    def precompute_aux(self, model, payload, x, y, mask):
        """The M-teacher ensemble collapsed to per-example statistics:

        Σ_m γ_m·KL(p_m‖p_s) = Σ_m γ_m Σ_c p_mc·log p_mc
                              − Σ_c (Σ_m γ_m p_mc)·log p_sc

        so the loss needs only the γ-mixture ``tbar`` (N, C) and the
        γ-weighted negative entropy ``tent`` (N,)."""
        parts = torch.stack([
            self.precompute_part(model, self._teacher(payload, i), x)
            for i in range(payload["gammas"].shape[0])])
        return self.precompute_combine(payload, parts, x, y, mask)

    def precompute_parts(self, payload):
        versions = payload.get("teacher_versions")
        if versions is None:
            return None
        keys = tuple(int(v) for v in np.asarray(versions))
        return keys, lambda m: self._teacher(payload, m)

    def precompute_part(self, model, part_payload, x):
        with torch.no_grad():
            return model.apply(part_payload, x).to(torch.float32)  # (N, C)

    def precompute_combine(self, payload, parts, x, y, mask):
        del x, y, mask
        logp = torch.log_softmax(parts.to(torch.float32) / self.temperature,
                                 dim=-1)
        p = torch.exp(logp)
        g = payload["gammas"].to(torch.float32)             # (M,)
        return {"tbar": torch.einsum("m,mnc->nc", g, p),
                "tent": torch.einsum("m,mnc->n", g, p * logp)}

    def loss_fn(self, model):
        temp = self.temperature

        def loss(params, payload, client_state, x, y, mask=None, aux=None):
            logits = model.apply(params, x)
            ce = D.cross_entropy(logits, y, mask=mask)
            if aux is not None:
                logp_s = torch.log_softmax(logits.to(torch.float32) / temp,
                                           dim=-1)
                kls = (aux["tent"] - torch.sum(aux["tbar"] * logp_s, dim=-1)
                       ) * (temp * temp)                      # Σ_m γ_m·KL_m
                kd = 0.5 * D.masked_mean(kls, mask)
            else:
                kls = []
                for i in range(payload["gammas"].shape[0]):
                    with torch.no_grad():
                        t_logits = model.apply(self._teacher(payload, i), x)
                    kls.append(D.masked_mean(
                        D.kl_divergence(t_logits, logits, temp), mask))
                kd = 0.5 * torch.sum(payload["gammas"] * torch.stack(kls))
            return ce + kd, {"kd": kd}

        return loss

    def batched_loss_fn(self, model):
        if type(self).loss_fn is not FedGKDVote.loss_fn:
            return None
        temp = self.temperature

        def loss(params, payload, client_states, x, y, mask, aux=None):
            logits = model.apply(params, x)                   # (K, B, C)
            per = D.cross_entropy_per_client(logits, y, mask=mask)
            if aux is not None:
                logp_s = torch.log_softmax(logits.to(torch.float32) / temp,
                                           dim=-1)
                kls = (aux["tent"] - torch.sum(aux["tbar"] * logp_s, dim=-1)
                       ) * (temp * temp)                      # (K, B)
                kd = 0.5 * D.masked_mean_per_client(kls, mask)
            else:
                k, b = x.shape[0], x.shape[1]
                xf = x.reshape((k * b,) + tuple(x.shape[2:]))
                kls = []
                for i in range(payload["gammas"].shape[0]):
                    with torch.no_grad():                     # shared model
                        t = model.apply(self._teacher(payload, i),
                                        xf).reshape(k, b, -1)
                    kls.append(D.masked_mean_per_client(
                        D.kl_divergence(t, logits, temp), mask))
                kd = 0.5 * torch.sum(payload["gammas"][:, None]
                                     * torch.stack(kls), dim=0)
            per = per + kd
            return torch.sum(per), per

        return loss

    def server_update(self, server, uploads, weights, model, val_batch=None,
                      n_clients=None):
        server = super().server_update(server, uploads, weights, model,
                                       val_batch, n_clients)
        self._refresh_val_losses(server, model, val_batch)
        return server

    def absorb_stale(self, server, uploads, staleness, weights, model=None,
                     val_batch=None):
        """An absorbed teacher needs a vote too: the validation losses are
        recomputed over the buffer, or without a validation batch the new
        entry is priced at the worst current loss (the smallest vote).  A
        push is told by the newest version, not the length: a full buffer
        keeps its length."""
        newest = server["buffer"].versions[0]
        server = super().absorb_stale(server, uploads, staleness, weights,
                                      model, val_batch)
        if server["buffer"].versions[0] == newest:
            return server
        if model is not None and val_batch is not None:
            self._refresh_val_losses(server, model, val_batch)
        else:
            worst = max(server["val_losses"], default=0.0)
            server["val_losses"] = (
                [worst] + list(server["val_losses"]))[:len(server["buffer"])]
        return server

    def _refresh_val_losses(self, server, model, val_batch):
        # the validation loss of each buffered model sets its vote
        if val_batch is None:
            server["val_losses"] = [0.0] * len(server["buffer"])
            return
        vx, vy = val_batch
        with torch.no_grad():
            server["val_losses"] = [
                float(D.cross_entropy(model.apply(p, vx), vy))
                for p in server["buffer"].models]


# ---------------------------------------------------------------------------

class MOON(Algorithm):
    """Model-contrastive FL: positive = global features, negative = the
    client's previous local model's features (projection head, τ = 0.5)."""

    name = "moon"
    needs_projection_head = True

    def __init__(self, mu: float = 5.0, tau: float = 0.5, **kw):
        super().__init__(mu=mu, tau=tau, **kw)
        self.mu, self.tau = mu, tau

    def round_payload(self, server):
        return {"global": server["global"]}

    def init_client_state(self, client_id, global_params):
        return {"prev": global_params}

    def loss_fn(self, model):
        mu, tau = self.mu, self.tau

        def cos(a, b):
            # eps inside the rsqrt: the gradient stays finite for an
            # all-zero feature row
            a = a * torch.rsqrt(torch.sum(a * a, -1, keepdim=True) + 1e-12)
            b = b * torch.rsqrt(torch.sum(b * b, -1, keepdim=True) + 1e-12)
            return torch.sum(a * b, dim=-1)

        def loss(params, payload, client_state, x, y, mask=None, aux=None):
            # the bundles' apply is the classifier on ``features``: one
            # student forward serves both the logits and z
            z = model.features(params, x)
            logits = layers.dense(params[model.head_key], z)
            with torch.no_grad():
                z_g = model.features(payload["global"], x)
                z_p = model.features(client_state["prev"], x)
            pos = torch.exp(cos(z, z_g) / tau)
            neg = torch.exp(cos(z, z_p) / tau)
            con = -D.masked_mean(torch.log(pos / (pos + neg) + 1e-12), mask)
            return (D.cross_entropy(logits, y, mask=mask) + mu * con,
                    {"con": con})

        return loss

    def update_client_state(self, client_state, params, payload=None):
        return {"prev": params}


# ---------------------------------------------------------------------------

class FedDistillPlus(Algorithm):
    """FedDistill (per-label averaged logits shared) + parameter sharing.

    Clients upload their per-class logit sums and label counts; the server
    averages them into a global (C, C) table, next round's per-label
    teacher.
    """

    name = "feddistill+"

    def __init__(self, beta: float = 0.1, temperature: float = 1.0, **kw):
        super().__init__(beta=beta, **kw)
        self.beta, self.temperature = beta, temperature

    def init_server(self, global_params, model, num_classes):
        device = tree_leaves(global_params)[0].device
        return {"global": global_params, "round": 0,
                "label_logits": torch.zeros((num_classes, num_classes),
                                            device=device),
                "have_logits": torch.zeros((), device=device)}

    def round_payload(self, server):
        return {"label_logits": server["label_logits"],
                "enable": server["have_logits"]}

    def precompute_aux(self, model, payload, x, y, mask):
        # the label-table gather is round-constant per example
        del model, x, mask
        return {"teacher": payload["label_logits"][y]}    # (N, C)

    def loss_fn(self, model):
        beta, temp = self.beta, self.temperature

        def loss(params, payload, client_state, x, y, mask=None, aux=None):
            logits = model.apply(params, x)
            teacher = (aux["teacher"] if aux is not None
                       else payload["label_logits"][y])   # (B, C)
            kd = D.masked_mean(D.kl_divergence(teacher, logits, temp), mask)
            ce = D.cross_entropy(logits, y, mask=mask)
            return ce + beta * payload["enable"] * kd, {"kd": kd}

        return loss

    def client_finalize(self, model, params, x, y, mask, payload):
        with torch.no_grad():
            logits = model.apply(params, x)
            c = logits.shape[-1]
            onehot = _one_hot(y, c) * mask[:, None]
            return {"logit_sums": onehot.T @ logits,            # (C, C)
                    "label_counts": torch.sum(onehot, dim=0)}  # (C,)

    def server_update(self, server, uploads, weights, model, val_batch=None,
                      n_clients=None):
        server = super().server_update(server, uploads, weights, model,
                                       val_batch, n_clients)
        sums = sum(u["logit_sums"] for u in uploads)
        counts = sum(u["label_counts"] for u in uploads)
        server["label_logits"] = sums / torch.clamp(counts[:, None], min=1.0)
        server["have_logits"] = torch.ones_like(server["have_logits"])
        return server


# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _GenCfg:
    noise_dim: int = 32
    hidden: int = 128
    steps: int = 50
    lr: float = 1e-3
    alpha: float = 1.0       # client regularization coefficient


GEN_BATCH = 64               # generated examples per server step


class FedGen(Algorithm):
    """Data-free KD with a server-trained feature generator (Zhu et al.).

    Server: trains G(z, y) -> penultimate feature so the clients' uploaded
    classifier heads, weighted by their label counts, classify it as y.
    Client: adds the CE of its own head on generated features for labels
    drawn from the global label distribution.

    The noise comes from two sources, each a constructor argument:
    ``client_noise(payload, labels, batch) -> (y_gen, z)`` per local step
    (``labels`` are the batch's, zeroed where the mask is 0) and
    ``server_noise(round, step) -> (y, z)`` per generator step.  Where one
    is not given, ``noise_sources`` puts in the default: draws from
    ``torch.Generator``s on the CPU, seeded from the round and the batch's
    label sum (the client) or from the round and the step (the server),
    moved to the device, so the card and the CPU see the same noise.  The
    client's default reads the label sum and the label distribution back
    from the device, two synchronisations a local step.  The vmapped round
    body cannot read back inside ``torch.func.vmap``: there the client
    noise of every (client, step) is drawn before the call, in that order
    (``host_step_inputs``), at the padded batch size, and reaches the loss
    through ``aux``.
    """

    name = "fedgen"

    def __init__(self, alpha: float = 1.0, noise_dim: int = 32,
                 hidden: int = 128, gen_steps: int = 50,
                 client_noise: Optional[Callable] = None,
                 server_noise: Optional[Callable] = None, **kw):
        super().__init__(alpha=alpha, **kw)
        self.gcfg = _GenCfg(noise_dim=noise_dim, hidden=hidden,
                            steps=gen_steps, alpha=alpha)
        self.client_noise, self.server_noise = client_noise, server_noise

    # generator params / apply -------------------------------------------
    def _gen_init(self, generator, num_classes, feat_dim):
        h = self.gcfg.hidden
        return {"fc1": layers.dense_bias_init(
                    generator, self.gcfg.noise_dim + num_classes, h),
                "fc2": layers.dense_bias_init(generator, h, feat_dim)}

    @staticmethod
    def _gen_apply(gp, z, y_onehot):
        h = torch.relu(layers.dense(gp["fc1"], torch.cat([z, y_onehot], -1)))
        return layers.dense(gp["fc2"], h)

    def init_server(self, global_params, model, num_classes):
        raise TypeError(
            "FedGen needs a data probe to size the generator's feature "
            "output; call init_server_with_probe(global_params, model, "
            "num_classes, probe_x) instead (the FL loop does this).")

    def init_server_with_probe(self, global_params, model, num_classes,
                               probe_x):
        with torch.no_grad():
            feat_dim = model.features(global_params, probe_x[:1]).shape[-1]
        device = tree_leaves(global_params)[0].device
        gen = self._gen_init(torch.Generator().manual_seed(17), num_classes,
                             feat_dim)
        return {"global": global_params, "round": 0,
                "gen": tree_map(lambda t: t.to(device), gen),
                "num_classes": num_classes,
                "label_dist": torch.ones((num_classes,), device=device)
                / num_classes}

    def round_payload(self, server):
        return {"gen": server["gen"], "label_dist": server["label_dist"],
                "round": server["round"]}

    def noise_sources(self, num_classes):
        """(client_noise, server_noise): the constructor's, or the defaults
        where it was given none."""
        return (self.client_noise or self._client_noise,
                self.server_noise or functools.partial(
                    self._server_noise, num_classes=num_classes))

    def host_step_inputs(self, payload, ys, mask):
        noise = self.noise_sources(payload["label_dist"].shape[0])[0]
        k, s, b = ys.shape
        draws = [noise(payload, ys[i, j] * mask[i, j].to(ys.dtype), b)
                 for i in range(k) for j in range(s)]
        return {"gen_y": torch.stack([d[0].cpu() for d in draws])
                .reshape(k, s, b),
                "gen_z": torch.stack([d[1].cpu() for d in draws])
                .reshape(k, s, b, -1)}

    def _client_noise(self, payload, labels, b):
        seed = (payload["round"] << 32) + int(labels.sum())
        g = torch.Generator().manual_seed(seed)
        probs = payload["label_dist"].detach().cpu() + 1e-9
        y_gen = torch.multinomial(probs, b, replacement=True, generator=g)
        z = torch.randn((b, self.gcfg.noise_dim), generator=g)
        return y_gen.to(labels.device), z.to(labels.device)

    def _server_noise(self, rnd, step, num_classes):
        g = torch.Generator().manual_seed(((1000 + rnd) << 16) + step)
        y = torch.randint(0, num_classes, (GEN_BATCH,), generator=g)
        z = torch.randn((GEN_BATCH, self.gcfg.noise_dim), generator=g)
        return y, z

    def loss_fn(self, model):
        alpha = self.gcfg.alpha

        def loss(params, payload, client_state, x, y, mask=None, aux=None):
            logits = model.apply(params, x)
            ce = D.cross_entropy(logits, y, mask=mask)
            c = payload["label_dist"].shape[0]
            if aux is not None and "gen_y" in aux:
                y_gen, z = aux["gen_y"], aux["gen_z"]
            else:
                y_eff = y if mask is None else y * mask.to(y.dtype)
                y_gen, z = self.noise_sources(c)[0](payload, y_eff,
                                                    x.shape[0])
            with torch.no_grad():
                feats = self._gen_apply(payload["gen"], z,
                                        _one_hot(y_gen, c))
            gen_logits = layers.dense(params[model.head_key], feats)
            reg = D.cross_entropy(gen_logits, y_gen, mask=mask)
            return ce + alpha * reg, {"gen_ce": reg}

        return loss

    def client_finalize(self, model, params, x, y, mask, payload):
        c = payload["label_dist"].shape[0]
        return {"head": params[model.head_key],
                "label_counts": torch.sum(_one_hot(y, c) * mask[:, None],
                                          dim=0)}

    def server_update(self, server, uploads, weights, model, val_batch=None,
                      n_clients=None):
        server = Algorithm.server_update(self, server, uploads, weights, model)
        c = server["num_classes"]
        counts = sum(u["label_counts"] for u in uploads)
        server["label_dist"] = counts / torch.clamp(torch.sum(counts), min=1.0)
        heads = [u["head"] for u in uploads]
        head_w = torch.stack([u["label_counts"] for u in uploads])  # (K, C)
        head_w = head_w / torch.clamp(torch.sum(head_w, 0, keepdim=True),
                                      min=1.0)
        device = head_w.device
        noise = self.noise_sources(c)[1]
        gen = server["gen"]
        for i in range(self.gcfg.steps):
            y, z = (t.to(device) for t in noise(server["round"], i))
            leaves, rebuild = tree_flatten(gen)
            leaves = [p.detach().requires_grad_(True) for p in leaves]
            with torch.enable_grad():
                feats = self._gen_apply(
                    rebuild(leaves), z,
                    torch.nn.functional.one_hot(y.long(), c)
                    .to(torch.float32))
                total = 0.0
                for k, head in enumerate(heads):
                    logp = torch.log_softmax(layers.dense(head, feats), -1)
                    w = head_w[k][y]                  # weight by label counts
                    total = total - torch.mean(
                        w * torch.gather(logp, 1, y[:, None].long())[:, 0])
                grads = torch.autograd.grad(total, leaves)
            with torch.no_grad():
                gen = rebuild([p - self.gcfg.lr * g
                               for p, g in zip(leaves, grads)])
        server["gen"] = gen
        return server


# ---------------------------------------------------------------------------

class SCAFFOLD(Algorithm):
    """Karimireddy et al. 2019: control variates correct client drift.

    The local gradient is corrected by (c − c_k); the server folds the
    option-II update of the control variates into its aggregation:
        Δc_k = (w_t − w_k)/(K_steps·η) − c,  c ← c + (|S|/K)·mean Δc_k.
    """

    name = "scaffold"

    def __init__(self, lr: float = 0.05, local_steps_hint: int = 20, **kw):
        super().__init__(**kw)
        self.lr = lr
        self.local_steps_hint = local_steps_hint

    def init_server(self, global_params, model, num_classes):
        zeros = tree_map(torch.zeros_like, global_params)
        return {"global": global_params, "round": 0, "c": zeros}

    def round_payload(self, server):
        return {"c": server["c"], "anchor": server["global"]}

    def init_client_state(self, client_id, global_params):
        return {"c_k": tree_map(torch.zeros_like, global_params)}

    def loss_fn(self, model):
        def loss(params, payload, client_state, x, y, mask=None, aux=None):
            logits = model.apply(params, x)
            ce = D.cross_entropy(logits, y, mask=mask)
            # linear correction: <(c − c_k), w> has gradient (c − c_k)
            corr = sum(
                torch.sum((c - ck).to(torch.float32) * w.to(torch.float32))
                for c, ck, w in zip(tree_leaves(payload["c"]),
                                    tree_leaves(client_state["c_k"]),
                                    tree_leaves(params)))
            return ce + corr, {}

        return loss

    def server_update(self, server, uploads, weights, model, val_batch=None,
                      n_clients=None):
        k_eta = self.local_steps_hint * self.lr
        anchor, c_global = server["global"], server["c"]
        deltas = [tree_map(lambda wt, wk, c: (wt.to(torch.float32)
                                              - wk.to(torch.float32)) / k_eta
                           - c, anchor, u["params"], c_global)
                  for u in uploads]
        mean_delta = tree_map(lambda *xs: sum(xs) / len(xs), *deltas)
        # participation fraction |S|/K over the whole population; without
        # n_clients, full participation
        frac = len(uploads) / max(1, n_clients if n_clients is not None
                                  else len(uploads))
        server = Algorithm.server_update(self, server, uploads, weights, model)
        server["c"] = tree_map(lambda c, d: c + frac * d, server["c"],
                               mean_delta)
        return server


class FedDyn(Algorithm):
    """Acar et al. 2020: dynamic regularization — each client keeps a
    first-order dual state h_k; the local objective adds −<h_k, w> +
    (α/2)‖w − w_t‖²."""

    name = "feddyn"

    def __init__(self, alpha: float = 0.01, **kw):
        super().__init__(alpha=alpha, **kw)
        self.alpha = alpha

    def round_payload(self, server):
        return {"anchor": server["global"]}

    def init_client_state(self, client_id, global_params):
        return {"h": tree_map(torch.zeros_like, global_params)}

    def loss_fn(self, model):
        a = self.alpha

        def loss(params, payload, client_state, x, y, mask=None, aux=None):
            logits = model.apply(params, x)
            ce = D.cross_entropy(logits, y, mask=mask)
            lin = sum(torch.sum(h.to(torch.float32) * w.to(torch.float32))
                      for h, w in zip(tree_leaves(client_state["h"]),
                                      tree_leaves(params)))
            prox = 0.5 * a * D.param_sq_dist(params, payload["anchor"])
            return ce - lin + prox, {}

        return loss

    def update_client_state(self, client_state, params, payload=None):
        # dual update: h_k <- h_k - alpha·(w_k - w_t)
        a = self.alpha
        return {"h": tree_map(
            lambda h, wk, wt: h - a * (wk.to(h.dtype) - wt.to(h.dtype)),
            client_state["h"], params, payload["anchor"])}


_ALGOS = {
    "fedavg": Algorithm,
    "fedprox": FedProx,
    "fedgkd": FedGKD,
    "fedgkd+": FedGKDPlus,
    "fedgkd-vote": FedGKDVote,
    "moon": MOON,
    "feddistill+": FedDistillPlus,
    "fedgen": FedGen,
    "scaffold": SCAFFOLD,
    "feddyn": FedDyn,
}


def make(name: str, **kw) -> Algorithm:
    if name not in _ALGOS:
        raise ValueError(f"unknown algorithm {name!r}; available: "
                         f"{available()}")
    return _ALGOS[name](**kw)


def available() -> list[str]:
    return sorted(_ALGOS)
