"""Client execution: how one round's sampled clients are trained.

Two of the reference's executors (``repro.core.executor``):

``SequentialExecutor`` — the reference loop, clients one at a time in
cohort order, one ``client.make_step`` per batch, no padding and no masks.
When the algorithm has a precompute stage (FedGKD: the teacher's logits),
the teacher runs once over the client's whole shard, without autograd and
in chunks, and is gathered by the batch picks to (S, B, ...).  After the
last step it runs the algorithm's ``client_finalize`` over the whole shard
(FedDistill+'s logit table, FedGen's head) and ``update_client_state``
(MOON's previous model, FedDyn's dual state).
``executor="auto"`` picks it for the text encoder (no client-batched form)
and for a cohort of one.

``VmapExecutor`` on its client-batched route, which ``"auto"`` picks for
ResNet-8 with every algorithm that has a ``batched_loss_fn`` (FedAvg,
FedProx, FedGKD, FedGKD-VOTE, FedGKD+); the others (MOON, FedDistill+,
SCAFFOLD, FedDyn, FedGen) have none and run sequentially.  Per round it

  1. stacks each sampled client's FULL shard to (K, N_max, ...) and runs the
     algorithm's ``precompute_aux`` once over it, folding K into the batch
     axis, without autograd, in chunks;
  2. draws every client's batch picks from the numpy generator in the
     reference's order (``materialize_picks``) and stacks them to
     (K, S, B, ...) with an example mask and a step mask;
  3. gathers the precomputed rows per batch and runs the whole cohort's
     local SGD as one client-stacked program
     (``client.make_batched_local_update``).

Ragged clients are exact, not approximate: every batch of a client has
``min(B, n_k)`` examples, padded across clients to the cohort maximum
behind a zero example mask, and a client with fewer steps gets whole
padded steps that leave its params and optimizer state untouched.

The vmapped round body (models without a client-batched form), the
client hooks on the vmap executor, shard_map and async execution are not
ported yet; asking for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import client as client_lib
from repro_torch.core.algorithms import Algorithm
from repro_torch.core.modelzoo import ModelBundle
from repro_torch.data.pipeline import ClientData
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_map

# rows per teacher-forward chunk of the precompute stage (K folded into N)
PRECOMPUTE_CHUNK = 1024


@dataclasses.dataclass
class RoundContext:
    """Everything fixed across rounds that an executor needs."""
    algo: Algorithm
    model: ModelBundle
    opt: Optimizer
    lr: float
    batch_size: int
    epochs: int
    device: torch.device
    max_batches: Optional[int] = None

    def __post_init__(self):
        self.step = client_lib.make_step(self.algo.loss_fn(self.model),
                                         self.opt)
        bloss = (self.algo.batched_loss_fn(self.model)
                 if self.model.client_batched else None)
        self.batched_local_update = (
            None if bloss is None
            else client_lib.make_batched_local_update(bloss, self.opt))
        # hooks left at the Algorithm defaults are no-ops: the executors
        # skip calling them
        cls = type(self.algo)
        self.has_precompute = (
            cls.precompute_aux is not Algorithm.precompute_aux)
        self.has_finalize = (
            cls.client_finalize is not Algorithm.client_finalize)
        self.has_state_update = (
            cls.update_client_state is not Algorithm.update_client_state)
        # which route and body ran: written by the executor, read by tests
        self.telemetry: dict = {}


@dataclasses.dataclass
class RoundResult:
    uploads: list[dict]
    weights: list[float]
    local_losses: list[float]
    client_states: list[Any]


# ---------------------------------------------------------------------------
# batch materialization (numpy on the host, the reference's rng order)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MaterializedClient:
    xs: np.ndarray      # (S_k, bs_k, ...)
    ys: np.ndarray      # (S_k, bs_k)
    n: int              # true example count (aggregation weight)
    picks: np.ndarray   # (S_k, bs_k) int32 — shard-row index of each example


def materialize_picks(rng: np.random.Generator, data: ClientData,
                      batch_size: int, epochs: int,
                      max_batches: Optional[int] = None) -> np.ndarray:
    """The client's epoch batch INDICES, (S_k, bs_k) int32: one permutation
    per started epoch, the final partial batch wrap-padded — the
    reference's exact ``rng`` consumption."""
    n = data.n
    bs = min(batch_size, n)
    picks: list[np.ndarray] = []
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n, bs):
            idx = order[i:i + bs]
            if len(idx) < bs:               # wrap the final partial batch
                idx = np.concatenate([idx, order[: bs - len(idx)]])
            picks.append(idx)
            if max_batches is not None and len(picks) >= max_batches:
                break
        if max_batches is not None and len(picks) >= max_batches:
            break
    return np.stack(picks).astype(np.int32)


def materialize_client(rng: np.random.Generator, data: ClientData,
                       batch_size: int, epochs: int,
                       max_batches: Optional[int] = None) -> MaterializedClient:
    """``materialize_picks`` plus the host-side row gather."""
    sel = materialize_picks(rng, data, batch_size, epochs, max_batches)
    return MaterializedClient(data.x[sel], data.y[sel], data.n, sel)


def _pad_and_stack(mats: list[MaterializedClient], device):
    """(K, S, B, ...) batches + example mask (K, S, B) + picks (K, S, B) +
    step mask (K, S), on ``device``.  Padded picks point at row 0; the
    example mask zero-weights whatever they gather."""
    S = max(m.xs.shape[0] for m in mats)
    B = max(m.xs.shape[1] for m in mats)
    k = len(mats)
    feat = mats[0].xs.shape[2:]
    xs = np.zeros((k, S, B) + feat, mats[0].xs.dtype)
    ys = np.zeros((k, S, B), np.int64)
    ex_mask = np.zeros((k, S, B), np.float32)
    picks = np.zeros((k, S, B), np.int64)
    step_mask = np.zeros((k, S), bool)
    for i, m in enumerate(mats):
        s, b = m.xs.shape[:2]
        xs[i, :s, :b] = m.xs
        ys[i, :s, :b] = m.ys
        ex_mask[i, :s, :b] = 1.0
        picks[i, :s, :b] = m.picks
        step_mask[i, :s] = True
    return tuple(torch.from_numpy(a).to(device)
                 for a in (xs, ys, ex_mask, picks, step_mask))


def _pad_full_data(client_data: list[ClientData], device):
    """Each client's FULL shard stacked to (K, N_max, ...) + labels + mask,
    on ``device``; pad rows are zeros behind a zero mask."""
    n_max = max(d.n for d in client_data)
    k = len(client_data)
    feat = client_data[0].x.shape[1:]
    xs = np.zeros((k, n_max) + feat, client_data[0].x.dtype)
    ys = np.zeros((k, n_max), np.int64)
    mask = np.zeros((k, n_max), np.float32)
    for i, d in enumerate(client_data):
        xs[i, :d.n] = d.x
        ys[i, :d.n] = d.y
        mask[i, :d.n] = 1.0
    return tuple(torch.from_numpy(a).to(device) for a in (xs, ys, mask))


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

def _precompute_rows(ctx: RoundContext, payload, x, y, mask):
    """``precompute_aux`` over the rows of ``x`` (N, ...),
    PRECOMPUTE_CHUNK rows at a time, without autograd: leaves (N, ...)."""
    chunks = []
    with torch.no_grad():
        for lo in range(0, x.shape[0], PRECOMPUTE_CHUNK):
            sl = slice(lo, lo + PRECOMPUTE_CHUNK)
            chunks.append(ctx.algo.precompute_aux(ctx.model, payload, x[sl],
                                                  y[sl], mask[sl]))
    return tree_map(lambda *parts: torch.cat(parts), *chunks)


class SequentialExecutor:
    """The reference implementation: clients one at a time, one step per
    batch."""

    name = "sequential"

    def run_round(self, ctx: RoundContext, global_params, payload,
                  client_states, client_data, rng: np.random.Generator,
                  client_ids=None) -> RoundResult:
        ctx.telemetry["route"] = "sequential"
        dev = ctx.device
        uploads, weights, losses, new_states = [], [], [], []
        for state, cdata in zip(client_states, client_data):
            mat = materialize_client(rng, cdata, ctx.batch_size, ctx.epochs,
                                     ctx.max_batches)
            xs, ys = (torch.from_numpy(a).to(dev) for a in (mat.xs, mat.ys))
            aux_steps = ()
            if ctx.has_precompute or ctx.has_finalize:
                full_x, full_y = (torch.from_numpy(a).to(dev)
                                  for a in (cdata.x, cdata.y))
                full_mask = torch.ones(cdata.n, device=dev)
            if ctx.has_precompute:
                aux_full = _precompute_rows(ctx, payload, full_x, full_y,
                                            full_mask)
                picks = torch.from_numpy(mat.picks).to(dev).long()
                aux_steps = tree_map(lambda l: l[picks], aux_full)
            params, opt_state = global_params, ctx.opt.init(global_params)
            step_losses = []
            for s in range(xs.shape[0]):
                params, opt_state, loss, _ = ctx.step(
                    params, opt_state, payload, state, xs[s], ys[s], None,
                    tree_map(lambda l: l[s], aux_steps), ctx.lr)
                step_losses.append(loss)
            extras = {}
            if ctx.has_finalize:
                extras = ctx.algo.client_finalize(ctx.model, params, full_x,
                                                  full_y, full_mask, payload)
            new_states.append(
                ctx.algo.update_client_state(state, params, payload)
                if ctx.has_state_update else state)
            uploads.append({"params": params, **extras})
            weights.append(float(mat.n))
            # one device->host copy per client; the mean in float64 over
            # the fp32 step losses, as the reference's np.mean of floats
            losses.append(float(np.mean(torch.stack(step_losses).tolist()))
                          if step_losses else 0.0)
        return RoundResult(uploads, weights, losses, new_states)


class VmapExecutor:
    """The reference's batched executor, on its client-batched route: one
    client-stacked program trains the whole cohort."""

    name = "vmap"

    @staticmethod
    def _precompute(ctx: RoundContext, payload, fx, fy, fmask):
        """``precompute_aux`` over (K, N_max) shards with K folded into the
        batch axis: leaves (K, N_max, ...)."""
        k, n = fx.shape[0], fx.shape[1]
        flat = [t.reshape((k * n,) + tuple(t.shape[2:])) for t in (fx, fy, fmask)]
        return tree_map(lambda l: l.reshape((k, n) + tuple(l.shape[1:])),
                        _precompute_rows(ctx, payload, *flat))

    def run_round(self, ctx: RoundContext, global_params, payload,
                  client_states, client_data, rng: np.random.Generator,
                  client_ids=None) -> RoundResult:
        ctx.telemetry["route"] = "vmap"
        if ctx.batched_local_update is None:
            raise NotImplementedError(
                "the vmapped round body (models or algorithms without a "
                "client-batched form) is not ported yet (ROADMAP A8b part 2)")
        if ctx.has_finalize or ctx.has_state_update:
            raise NotImplementedError(
                f"{ctx.algo.name}: client_finalize / update_client_state on "
                f"the vmap executor are not ported yet (ROADMAP A8b part 2); "
                f"use the sequential executor")
        ctx.telemetry["round_body"] = "client_batched"
        k = len(client_data)
        aux_full = None
        if ctx.has_precompute:
            # the teacher forward needs no batch picks: it goes first, as in
            # the reference, so the device works while the host pads below
            aux_full = self._precompute(ctx, payload,
                                        *_pad_full_data(client_data, ctx.device))
        mats = [materialize_client(rng, d, ctx.batch_size, ctx.epochs,
                                   ctx.max_batches) for d in client_data]
        xs, ys, ex_mask, picks, step_mask = _pad_and_stack(mats, ctx.device)
        states = tuple(client_states)
        aux = ()
        if ctx.has_precompute:
            rows = torch.arange(k, device=ctx.device)[:, None, None]
            aux = tree_map(lambda l: l[rows, picks], aux_full)
        params_stacked, mloss = ctx.batched_local_update(
            global_params, payload, states, xs, ys, ex_mask, aux, step_mask,
            ctx.lr)
        uploads = [{"params": tree_map(lambda l, i=i: l[i], params_stacked)}
                   for i in range(k)]
        return RoundResult(uploads, [float(m.n) for m in mats],
                           mloss.cpu().tolist(), list(client_states))


_EXECUTORS = {"sequential": SequentialExecutor, "vmap": VmapExecutor}
_NOT_PORTED = {
    "shard_map": "ROADMAP A8b and A13",
    "async": "ROADMAP A10",
}


def available() -> list[str]:
    return sorted(_EXECUTORS) + ["auto"]


def get_executor(spec, algo: Algorithm, n_sample: int, model: ModelBundle):
    """Resolve an executor spec.  ``"auto"`` picks the vmap executor's
    client-batched route when the algorithm ``supports_vmap``, more than
    one client is sampled and the model is ``client_batched`` with an
    algorithm that has ``batched_loss_fn``; the sequential executor
    otherwise.  Instances pass through."""
    if not isinstance(spec, str):
        return spec
    if spec == "auto":
        batched_ok = (algo.supports_vmap and n_sample > 1
                      and model.client_batched
                      and algo.batched_loss_fn(model) is not None)
        spec = "vmap" if batched_ok else "sequential"
    if spec in _EXECUTORS:
        return _EXECUTORS[spec]()
    if spec in _NOT_PORTED:
        raise NotImplementedError(
            f"executor {spec!r} is not ported yet ({_NOT_PORTED[spec]})")
    raise ValueError(f"unknown executor {spec!r}; available: {available()}")
