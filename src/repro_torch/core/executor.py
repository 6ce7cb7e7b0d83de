"""Client execution: how one round's sampled clients are trained.

The reference's executors (``repro.core.executor``):

``SequentialExecutor`` — the reference loop, clients one at a time in
cohort order, one ``client.make_step`` per batch, no padding and no masks.
With the precompute stage on (``RoundContext.precompute``; ``run_federated``
turns it off for this executor unless asked, as the reference does) the
teacher runs once over the client's whole shard, without autograd and in
chunks, and is gathered by the batch picks to (S, B, ...); off, the loss
runs the teacher inline on each batch.  After the last step it runs the
algorithm's ``client_finalize`` over the whole shard (FedDistill+'s logit
table, FedGen's head) and ``update_client_state`` (MOON's previous model,
FedDyn's dual state).

``VmapExecutor`` — the whole cohort as one client-stacked program.  Per
round it

  1. stacks each sampled client's FULL shard to (K, N_max, ...) and runs the
     algorithm's ``precompute_aux`` once over it, folding K into the batch
     axis, without autograd, in chunks; where the algorithm splits it into
     versioned parts (FedGKD-VOTE's M teachers, ``precompute_parts``) and
     the caller passes client ids, only the parts with a version new to a
     sampled client are computed, and the rest come from the cross-round
     cache ``RoundContext.aux_cache``;
  2. draws every client's batch picks from the numpy generator in the
     reference's order (``materialize_picks``) and stacks them to
     (K, S, B, ...) with an example mask and a step mask;
  3. trains the cohort by one of two bodies (``telemetry["round_body"]``):
     ``"client_batched"`` — for a ``client_batched`` model (ResNet-8/50)
     with an algorithm that has a ``batched_loss_fn``: the global params
     broadcast to a (K, ...) stack and one step on the summed per-client
     losses (``client.make_batched_local_update``), each conv one K-client
     launch; ``"vmap"`` — otherwise, or with ``client_batched=False``:
     ``torch.func.vmap`` of one client's masked pass
     (``client.make_local_update``) over the cohort, with the kernels'
     vmap rules folding the vmapped axis into their row or client axes;
  4. runs ``client_finalize`` and ``update_client_state`` as
     ``torch.func.vmap`` over the stacked params.

Ragged clients are exact, not approximate: every batch of a client has
``min(B, n_k)`` examples, padded across clients to the cohort maximum
behind a zero example mask, and a client with fewer steps gets whole
padded steps that leave its params and optimizer state untouched.

``ShardMapExecutor`` — the vmap executor's round with the cohort split
into one slice per device (phantom clients pad a cohort that does not
divide the device count), each client's shard resident on its slice's
device across rounds (``RoundContext.placement``), the slices' results
gathered to the first device.

``AsyncExecutor`` — buffered-asynchronous rounds on a simulated
heterogeneous system: the configuration and the inner executor that trains
each dispatch wave; the event loop is ``fl_loop._run_async``.

Every executor takes pre-drawn batch picks (``run_round(picks=)``): the
multi-host round draws the whole cohort's and trains the owned slice.
``executor="auto"`` picks the vmap executor for more than one sampled
client of a ``vmap_friendly`` model (the MLP) or of a client-batched pair,
the sequential executor otherwise (the text encoder; ResNet-8 with MOON,
FedDistill+, SCAFFOLD, FedDyn or FedGen).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import client as client_lib
from repro_torch.core.algorithms import Algorithm
from repro_torch.core.modelzoo import ModelBundle
from repro_torch.data.pipeline import ClientData, ClientSlabStore, slab_rows
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_map

_LOG = logging.getLogger(__name__)

# rows per teacher-forward chunk of the precompute stage (K folded into N)
PRECOMPUTE_CHUNK = 1024


@dataclasses.dataclass
class RoundContext:
    """Everything fixed across rounds that an executor needs.

    ``precompute=False`` forces the inline (no-aux) loss path.
    ``client_batched`` gates the vmap executor's client-batched round body:
    ``"auto"`` uses it whenever the model is ``client_batched`` and the
    algorithm has a ``batched_loss_fn``; ``False`` forces the vmapped
    round body; ``True`` also raises where the pair has no such form.

    ``deferred`` (the async loop's pipelined mode): the vmap executor
    returns its per-client losses as a tensor on the device instead of
    reading them back, and on the card uploads the wave's batches from
    pinned memory without blocking, so a wave's launch does not wait for
    the device; the loop reads the losses at aggregation.

    ``placement`` is the device-resident slab store
    (``data.pipeline.ClientSlabStore``, uncapped): the shard_map executor
    keeps each client's shard there across rounds, and the population tier
    attaches to it (a warm eviction drops the slab)."""
    algo: Algorithm
    model: ModelBundle
    opt: Optimizer
    lr: float
    batch_size: int
    epochs: int
    device: torch.device
    max_batches: Optional[int] = None
    precompute: bool = True
    client_batched: "bool | str" = "auto"
    deferred: bool = False

    def __post_init__(self):
        loss_fn = self.algo.loss_fn(self.model)
        self.step = client_lib.make_step(loss_fn, self.opt)
        # one client's masked pass, the vmapped round body's per-client fn
        self.local_update = client_lib.make_local_update(loss_fn, self.opt)
        self.batched_local_update = None
        if self.client_batched in ("auto", True):
            bloss = (self.algo.batched_loss_fn(self.model)
                     if self.model.client_batched else None)
            if bloss is not None:
                self.batched_local_update = (
                    client_lib.make_batched_local_update(bloss, self.opt))
            elif self.client_batched is True:
                raise ValueError(
                    f"client_batched=True but model {self.model.name!r} / "
                    f"algorithm {self.algo.name!r} has no client-batched "
                    f"form (ModelBundle.client_batched + "
                    f"Algorithm.batched_loss_fn)")
        # hooks left at the Algorithm defaults are no-ops: the executors
        # skip calling them
        cls = type(self.algo)
        self.has_precompute = (
            self.precompute
            and cls.precompute_aux is not Algorithm.precompute_aux)
        self.has_finalize = (
            cls.client_finalize is not Algorithm.client_finalize)
        self.has_state_update = (
            cls.update_client_state is not Algorithm.update_client_state)
        # cross-round cache of precompute parts, per client id and part
        # version: {cid: {key: (n, ...)}} (``VmapExecutor._incremental_aux``)
        self.aux_cache: dict = {}
        self.placement = ClientSlabStore()
        # which route and body ran, parts recomputed: written by the
        # executor, read by tests and chip_smoke
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
    return client_from_picks(data, materialize_picks(rng, data, batch_size,
                                                     epochs, max_batches))


def client_from_picks(data: ClientData,
                      sel: np.ndarray) -> MaterializedClient:
    """``materialize_client`` with the indices already drawn: the
    multi-host round draws the picks of the whole cohort (the generator in
    lockstep on every host) and hands the executor its owned slice."""
    sel = np.asarray(sel, np.int32)
    return MaterializedClient(data.x[sel], data.y[sel], data.n, sel)


def _client_mats(ctx: "RoundContext", client_data: list, rng, picks):
    """Each client's batches: from ``picks`` where given, else drawn from
    ``rng`` in cohort order."""
    if picks is not None:
        return [client_from_picks(d, p) for d, p in zip(client_data, picks)]
    return [materialize_client(rng, d, ctx.batch_size, ctx.epochs,
                               ctx.max_batches) for d in client_data]


def _pad_and_stack(mats: list[MaterializedClient]):
    """(K, S, B, ...) batches + example mask (K, S, B) + picks (K, S, B) +
    step mask (K, S), as CPU tensors.  Padded picks point at row 0; the
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
    return tuple(torch.from_numpy(a)
                 for a in (xs, ys, ex_mask, picks, step_mask))


def _upload(t: torch.Tensor, device: torch.device,
            non_blocking: bool = False) -> torch.Tensor:
    """A host tensor on ``device``; with ``non_blocking`` on the card it is
    staged in pinned memory, so the host does not wait for the stream."""
    if non_blocking and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _pad_full_data(client_data: list[ClientData], device,
                   non_blocking: bool = False):
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
    return tuple(_upload(torch.from_numpy(a), device, non_blocking)
                 for a in (xs, ys, mask))


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
                  client_ids=None, picks=None) -> RoundResult:
        """``picks``: each client's batch indices, drawn beforehand
        (``materialize_picks``); without them they are drawn from ``rng``
        in cohort order."""
        ctx.telemetry["route"] = "sequential"
        dev = ctx.device
        uploads, weights, losses, new_states = [], [], [], []
        # the generator serves only the picks: drawing every client's first
        # consumes it as drawing them client by client would
        mats = _client_mats(ctx, client_data, rng, picks)
        for state, cdata, mat in zip(client_states, client_data, mats):
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


def _tree_stack(trees: list) -> Any:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _tree_unstack(tree: Any, k: int) -> list:
    return [tree_map(lambda l, i=i: l[i], tree) for i in range(k)]


def _fold(t: torch.Tensor) -> torch.Tensor:
    """(K, N, ...) -> (K·N, ...)."""
    return t.reshape((-1,) + tuple(t.shape[2:]))


class VmapExecutor:
    """The reference's batched executor: one client-stacked program trains
    the whole cohort, on the client-batched route or through the vmapped
    round body."""

    name = "vmap"

    @staticmethod
    def _precompute(ctx: RoundContext, payload, fx, fy, fmask):
        """``precompute_aux`` over (K, N_max) shards with K folded into the
        batch axis: leaves (K, N_max, ...)."""
        k, n = fx.shape[0], fx.shape[1]
        return tree_map(lambda l: l.reshape((k, n) + tuple(l.shape[1:])),
                        _precompute_rows(ctx, payload, _fold(fx), _fold(fy),
                                         _fold(fmask)))

    @staticmethod
    def _part_rows(ctx: RoundContext, part_payload, fx):
        """``precompute_part`` over (K, N_max) shards, K folded into the
        rows, PRECOMPUTE_CHUNK rows a call: (K, N_max, ...)."""
        k, n = fx.shape[0], fx.shape[1]
        flat = _fold(fx)
        with torch.no_grad():
            out = torch.cat([
                ctx.algo.precompute_part(ctx.model, part_payload,
                                         flat[lo:lo + PRECOMPUTE_CHUNK])
                for lo in range(0, flat.shape[0], PRECOMPUTE_CHUNK)])
        return out.reshape((k, n) + tuple(out.shape[1:]))

    def _incremental_aux(self, ctx: RoundContext, payload, parts_spec,
                         client_ids, client_data, full):
        """The precompute through the cross-round part cache: only the
        parts whose version key is new for some sampled client are
        computed (steady state: ONE teacher forward over the stacked
        cohort a round instead of M), each once over the (K, N_max) stack;
        then the parts are folded by ``precompute_combine``.  Cached values
        are the part's outputs over the client's real rows."""
        keys, get_part = parts_spec
        fx, fy, fmask = full
        k, n_max = fx.shape[0], fx.shape[1]
        for cid in client_ids:
            ctx.aux_cache.setdefault(cid, {})
        fresh: dict = {}                 # freshly computed parts, by key
        for m, key in enumerate(keys):
            if key in fresh or all(key in ctx.aux_cache[cid]
                                   for cid in client_ids):
                continue
            fresh[key] = self._part_rows(ctx, get_part(m), fx)
            ctx.telemetry["parts_computed"] = (
                ctx.telemetry.get("parts_computed", 0) + 1)
            for i, (cid, d) in enumerate(zip(client_ids, client_data)):
                ctx.aux_cache[cid].setdefault(key, fresh[key][i, :d.n])
        keyset = set(keys)
        slabs = dict(fresh)
        for key in keyset - set(fresh):  # (K, N_max, ...) from the cache
            rows = [ctx.aux_cache[cid][key] for cid in client_ids]
            slabs[key] = rows[0].new_zeros((k, n_max) + tuple(rows[0].shape[1:]))
            for i, r in enumerate(rows):
                slabs[key][i, :r.shape[0]] = r
        parts = torch.stack([slabs[key] for key in keys])   # (P, K, N_max, .)
        # drop the versions that rotated out of the key set
        for cid in client_ids:
            ctx.aux_cache[cid] = {kk: v for kk, v in ctx.aux_cache[cid].items()
                                  if kk in keyset}
        with torch.no_grad():
            aux = ctx.algo.precompute_combine(
                payload, parts.reshape((len(keys), k * n_max)
                                       + tuple(parts.shape[3:])),
                _fold(fx), _fold(fy), _fold(fmask))
        return tree_map(lambda l: l.reshape((k, n_max) + tuple(l.shape[1:])),
                        aux)

    def run_round(self, ctx: RoundContext, global_params, payload,
                  client_states, client_data, rng: np.random.Generator,
                  client_ids=None, picks=None) -> RoundResult:
        ctx.telemetry["route"] = "vmap"
        batched = ctx.batched_local_update is not None
        ctx.telemetry["round_body"] = "client_batched" if batched else "vmap"
        dev = ctx.device
        k = len(client_data)
        full = aux_full = None
        if ctx.has_precompute or ctx.has_finalize:
            full = _pad_full_data(client_data, dev, ctx.deferred)
        if ctx.has_precompute:
            # the teacher forward needs no batch picks: it goes first, as in
            # the reference, so the device works while the host pads below
            parts_spec = (ctx.algo.precompute_parts(payload)
                          if client_ids is not None else None)
            aux_full = (self._incremental_aux(ctx, payload, parts_spec,
                                              client_ids, client_data, full)
                        if parts_spec is not None
                        else self._precompute(ctx, payload, *full))
        mats = _client_mats(ctx, client_data, rng, picks)
        host = _pad_and_stack(mats)
        xs, ys, ex_mask, picks, step_mask = (_upload(t, dev, ctx.deferred)
                                             for t in host)
        aux = {}
        if ctx.has_precompute:
            rows = torch.arange(k, device=dev)[:, None, None]
            aux = tree_map(lambda l: l[rows, picks], aux_full)
        if batched:
            params_stacked, mloss = ctx.batched_local_update(
                global_params, payload, tuple(client_states), xs, ys, ex_mask,
                aux or (), step_mask, ctx.lr)
        else:
            # inputs drawn on the host before the call (FedGen's noise): a
            # value read back inside torch.func.vmap is an error
            drawn = ctx.algo.host_step_inputs(payload, host[1], host[2])
            if drawn:
                aux = {**aux, **tree_map(lambda t: t.to(dev), drawn)}
            body = torch.func.vmap(ctx.local_update,
                                   in_dims=(None, None, 0, 0, 0, 0, 0, 0,
                                            None))
            params_stacked, mloss = body(
                global_params, payload, _tree_stack(client_states), xs, ys,
                ex_mask, aux or (), step_mask, ctx.lr)
        extras = [{}] * k
        if ctx.has_finalize:
            fx, fy, fmask = full
            extras = _tree_unstack(torch.func.vmap(
                lambda p, x, y, m: ctx.algo.client_finalize(
                    ctx.model, p, x, y, m, payload))(params_stacked, fx, fy,
                                                     fmask), k)
        new_states = list(client_states)
        if ctx.has_state_update:
            new_states = _tree_unstack(torch.func.vmap(
                lambda st, p: ctx.algo.update_client_state(st, p, payload))(
                    _tree_stack(client_states), params_stacked), k)
        uploads = [{"params": p, **e}
                   for p, e in zip(_tree_unstack(params_stacked, k), extras)]
        # deferred: the losses stay on the device, a (K,) tensor whose
        # entries the async loop reads at aggregation
        return RoundResult(uploads, [float(m.n) for m in mats],
                           mloss if ctx.deferred else mloss.cpu().tolist(),
                           new_states)


def _to(tree: Any, device) -> Any:
    """Every tensor of ``tree`` on ``device`` (no copy where it is)."""
    return tree_map(lambda l: l.to(device) if isinstance(l, torch.Tensor)
                    else l, tree)


def _pad_and_stack_picks(picks: list[np.ndarray], k_pad: int):
    """The per-client pick indices stacked to (k_pad, S, B) int64 with the
    example mask (k_pad, S, B) and the step mask (k_pad, S), on the host:
    the shard_map route's whole per-round upload besides the first sight
    of a client's slab.  Rows past ``len(picks)`` are phantom clients,
    whose all-zero masks make every step an identity."""
    s = max(p.shape[0] for p in picks)
    b = max(p.shape[1] for p in picks)
    out = np.zeros((k_pad, s, b), np.int64)
    ex_mask = np.zeros((k_pad, s, b), np.float32)
    step_mask = np.zeros((k_pad, s), bool)
    for i, p in enumerate(picks):
        out[i, :p.shape[0], :p.shape[1]] = p
        ex_mask[i, :p.shape[0], :p.shape[1]] = 1.0
        step_mask[i, :p.shape[0]] = True
    return out, ex_mask, step_mask


class ShardMapExecutor(VmapExecutor):
    """The reference's multi-device executor: the cohort split into one
    slice per device, each client's shard resident on its slice's device
    across rounds.

    ``devices``: the devices of the slices, in order; by default every
    card this host sees (``torch.cuda.device_count()``; under multi-host
    placement each host splits its own slice of the cohort over its own
    cards), or the run's one device on the CPU.  A device may repeat:
    ``["cuda:0", "cuda:0"]`` runs two slices on one card, the counterpart
    of the reference's forced host device count.  Per round:

      1. the cohort of K clients is padded with phantom clients to
         K_pad = ndev · ceil(K / ndev), slice d holding clients
         [d·g, (d+1)·g); each real client's shard comes from the slab
         store ``RoundContext.placement`` (uploaded the first time it is
         seen, moved device to device when its slice's device changes),
         padded to the slice's slab rows; phantom clients are zeros;
      2. the batch picks are drawn on the host in cohort order (or given),
         and each slice gathers its batches from its resident slabs on its
         device, so the host uploads only indices and masks;
      3. each slice runs the teacher precompute (or the part cache:
         ``_incremental_aux_sharded``) and the round body of the vmap
         executor (client-batched or vmapped) on its own clients; phantom
         clients are fully masked, so their steps are identities;
      4. the slices' params and losses are gathered to the first device,
         the phantom clients sliced off, and the client hooks run there.

    The slices run one after another on the current stream.  With one
    device the split cannot run: ``strict=True`` raises, otherwise the
    round degrades to the vmap executor's with a logged warning
    (``telemetry["route"] == "vmap-fallback"``), as the reference does.
    """

    name = "shard_map"

    def __init__(self, strict: bool = False, devices=None):
        self.strict = strict
        self.devices = devices

    def _devices(self, ctx: RoundContext) -> list[torch.device]:
        if self.devices is not None:
            return [torch.device(d) for d in self.devices]
        if ctx.device.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [ctx.device]

    def run_round(self, ctx: RoundContext, global_params, payload,
                  client_states, client_data, rng: np.random.Generator,
                  client_ids=None, picks=None) -> RoundResult:
        devices = self._devices(ctx)
        if len(devices) == 1:
            if self.strict:
                raise RuntimeError(
                    "ShardMapExecutor(strict=True): only one device, the "
                    "cohort cannot be split; pass devices= (a device may "
                    "repeat, e.g. ['cuda:0', 'cuda:0']) or drop strict to "
                    "allow the vmap fallback")
            _LOG.warning("shard_map executor: one device, degrading to the "
                         "vmap computation (pass devices= to split the "
                         "cohort)")
            result = super().run_round(ctx, global_params, payload,
                                       client_states, client_data, rng,
                                       client_ids, picks)
            ctx.telemetry.update(route="vmap-fallback", n_devices=1)
            return result
        return self._run_sharded(ctx, devices, global_params, payload,
                                 client_states, client_data, rng, client_ids,
                                 picks)

    def _resident_cohort(self, ctx: RoundContext, devices, client_data,
                         client_ids, g: int, rows: int) -> list[tuple]:
        """Per slice, (g, rows, ...) x, (g, rows) int32 y and (g, rows)
        mask on the slice's device, stacked from the resident slabs
        (device work; the host uploads a shard only the first time a
        client is seen); phantom clients are zeros."""
        feat = client_data[0].x.shape[1:]
        dtype = torch.from_numpy(client_data[0].x[:0]).dtype
        out = []
        for d, dev in enumerate(devices):
            fx = torch.zeros((g, rows) + feat, dtype=dtype, device=dev)
            fy = torch.zeros((g, rows), dtype=torch.int32, device=dev)
            fmask = torch.zeros((g, rows), device=dev)
            for j, i in enumerate(range(d * g, min((d + 1) * g,
                                                   len(client_data)))):
                cid = client_ids[i] if client_ids is not None else None
                e = ctx.placement.get(cid, client_data[i], dev)
                fx[j, :e["rows"]] = e["x"]
                fy[j, :e["rows"]] = e["y"]
                fmask[j, :e["n"]] = 1.0
            out.append((fx, fy, fmask))
        return out

    def _incremental_aux_sharded(self, ctx: RoundContext, payloads,
                                 parts_spec, client_ids, client_data, full,
                                 g: int) -> list:
        """The part cache on the slices: a version is computed (one teacher
        forward per slice, counted once in ``parts_computed``) only when
        some sampled client has not seen it; otherwise each slice's
        (g, rows, ...) part is reassembled from the per-client cache
        ``RoundContext.aux_cache`` (each client's real rows, as the vmap
        executor keeps them).  Then ``precompute_combine`` per slice."""
        keys, get_part = parts_spec
        k = len(client_ids)
        for cid in client_ids:
            ctx.aux_cache.setdefault(cid, {})
        slabs: dict = {}            # key -> [(g, rows, ...) per slice]
        for m, key in enumerate(keys):
            if key in slabs:
                continue
            if any(key not in ctx.aux_cache[cid] for cid in client_ids):
                slabs[key] = [self._part_rows(ctx, _to(get_part(m), fx.device),
                                              fx) for fx, _, _ in full]
                ctx.telemetry["parts_computed"] = (
                    ctx.telemetry.get("parts_computed", 0) + 1)
                for i, cid in enumerate(client_ids):
                    ctx.aux_cache[cid].setdefault(
                        key, slabs[key][i // g][i % g, :client_data[i].n])
                continue
            slabs[key] = []
            for d, (fx, _, _) in enumerate(full):
                members = range(d * g, min((d + 1) * g, k))
                first = ctx.aux_cache[client_ids[0]][key]
                slab = first.new_zeros((g, fx.shape[1]) + tuple(
                    first.shape[1:]), device=fx.device)
                for j, i in enumerate(members):
                    r = ctx.aux_cache[client_ids[i]][key]
                    slab[j, :r.shape[0]] = r
                slabs[key].append(slab)
        keyset = set(keys)
        for cid in client_ids:
            ctx.aux_cache[cid] = {kk: v for kk, v in ctx.aux_cache[cid].items()
                                  if kk in keyset}
        out = []
        for d, (fx, fy, fmask) in enumerate(full):
            parts = torch.stack([slabs[key][d] for key in keys])
            rows = fx.shape[1]
            with torch.no_grad():
                aux = ctx.algo.precompute_combine(
                    payloads[d], parts.reshape((len(keys), g * rows)
                                               + tuple(parts.shape[3:])),
                    _fold(fx), _fold(fy), _fold(fmask))
            out.append(tree_map(
                lambda l: l.reshape((g, rows) + tuple(l.shape[1:])), aux))
        return out

    def _run_sharded(self, ctx: RoundContext, devices, global_params,
                     payload, client_states, client_data, rng, client_ids,
                     picks) -> RoundResult:
        ndev, k = len(devices), len(client_data)
        g = -(-k // ndev)
        k_pad = g * ndev
        rows = max(slab_rows(d.n) for d in client_data)
        batched = ctx.batched_local_update is not None
        full = self._resident_cohort(ctx, devices, client_data, client_ids,
                                     g, rows)
        payloads = [_to(payload, dev) for dev in devices]
        aux_full: list = [()] * ndev
        if ctx.has_precompute:
            parts_spec = (ctx.algo.precompute_parts(payload)
                          if client_ids is not None else None)
            aux_full = (self._incremental_aux_sharded(
                ctx, payloads, parts_spec, client_ids, client_data, full, g)
                if parts_spec is not None else
                [self._precompute(ctx, pl, *f)
                 for pl, f in zip(payloads, full)])
        picks_list = (list(picks) if picks is not None else
                      [materialize_picks(rng, d, ctx.batch_size, ctx.epochs,
                                         ctx.max_batches)
                       for d in client_data])
        pk, ex_mask, step_mask = _pad_and_stack_picks(picks_list, k_pad)
        drawn = None
        if not batched:
            # inputs the loss draws on the host (FedGen's noise), over the
            # padded cohort: the real clients' draws are the vmap body's
            ys = np.zeros(pk.shape, np.int64)
            for i, d in enumerate(client_data):
                p = picks_list[i]
                ys[i, :p.shape[0], :p.shape[1]] = d.y[p]
            drawn = ctx.algo.host_step_inputs(payload, torch.from_numpy(ys),
                                              torch.from_numpy(ex_mask))
        phantom = tree_map(torch.zeros_like, client_states[0])
        states = list(client_states) + [phantom] * (k_pad - k)
        outs = []
        for d, dev in enumerate(devices):
            sl = slice(d * g, (d + 1) * g)
            fx, fy, _ = full[d]
            p_, em, sm = (torch.from_numpy(a[sl]).to(dev)
                          for a in (pk, ex_mask, step_mask))
            r = torch.arange(g, device=dev)[:, None, None]
            xs, ys = fx[r, p_], fy[r, p_].long()
            aux = (tree_map(lambda l: l[r, p_], aux_full[d])
                   if ctx.has_precompute else {})
            gp = _to(global_params, dev)
            if batched:
                outs.append(ctx.batched_local_update(
                    gp, payloads[d], tuple(_to(states[sl], dev)), xs, ys,
                    em, aux or (), sm, ctx.lr))
                continue
            if drawn:
                aux = {**aux, **tree_map(lambda t: t[sl].to(dev), drawn)}
            body = torch.func.vmap(ctx.local_update,
                                   in_dims=(None, None, 0, 0, 0, 0, 0, 0,
                                            None))
            outs.append(body(gp, payloads[d],
                             _to(_tree_stack(states[sl]), dev), xs, ys, em,
                             aux or (), sm, ctx.lr))
        dev0 = devices[0]
        # gather to the first device and drop the phantom clients
        params_stacked = tree_map(
            lambda *ls: torch.cat([l.to(dev0) for l in ls])[:k],
            *[p for p, _ in outs])
        mloss = torch.cat([m.to(dev0) for _, m in outs])[:k]
        extras = [{}] * k
        if ctx.has_finalize:
            fx, fy, fmask = (torch.cat([f[i].to(dev0) for f in full])[:k]
                             for i in range(3))
            pl0 = payloads[0]
            extras = _tree_unstack(torch.func.vmap(
                lambda p, x, y, m: ctx.algo.client_finalize(
                    ctx.model, p, x, y, m, pl0))(params_stacked, fx,
                                                 fy.long(), fmask), k)
        new_states = list(client_states)
        if ctx.has_state_update:
            new_states = _tree_unstack(torch.func.vmap(
                lambda st, p: ctx.algo.update_client_state(st, p,
                                                           payloads[0]))(
                    _to(_tree_stack(client_states), dev0), params_stacked), k)
        uploads = [{"params": p, **e}
                   for p, e in zip(_tree_unstack(params_stacked, k), extras)]
        ctx.telemetry.update(route="shard_map", n_devices=ndev, cohort=k,
                             padded_to=k_pad,
                             round_body=("client_batched" if batched
                                         else "vmap"),
                             placement=ctx.placement.stats())
        return RoundResult(uploads, [float(d.n) for d in client_data],
                           mloss if ctx.deferred else mloss.cpu().tolist(),
                           new_states)


class AsyncExecutor:
    """Straggler-aware buffered-asynchronous rounds.

    Clients run on a simulated heterogeneous system
    (``core.systemsim``), their uploads tagged with the global version they
    started from, and the server aggregates a buffer of ``buffer_size``
    completions with staleness weights
    (``server.async_aggregation_weights``).  The loop lives in
    ``fl_loop._run_async``; this class is its configuration and resolves
    the inner executor that trains each dispatch wave.

    Knobs (the reference's):
      buffer_size       aggregation buffer B (default: the cohort size)
      staleness         "constant" | "polynomial" | "fedgkd" (stale models
                        also join the teacher buffer: ``absorb_stale``)
      staleness_a       polynomial decay exponent, (1 + s)^(-a)
      staleness_cutoff  fedgkd: staleness past this is dropped from the
                        average (absorbed only); None = never dropped
      profile           ``systemsim.SpeedProfile`` of per-client speeds
      availability      optional ``systemsim.Availability`` duty cycle
      inner             the wave trainer: spec or instance
      base_step_time    virtual seconds per unit of local work
                        (``systemsim.measure_step_time`` calibrates it)
      pipelined         True (default): the inner executor defers its loss
                        read back (``RoundContext.deferred``) and the loop
                        dispatches the refill wave before the round's
                        evaluation; False: the evaluation first, then the
                        refill.  The values are the same either way.
      wave_slots        "auto" (default), "variable", None or an int >= 1,
                        validated as the reference does.  The reference
                        pads each wave to that many client slots so one
                        compiled body serves the run; eager PyTorch has no
                        per-shape compile, so the port trains every wave
                        at its own size and reports no ``compile_count``.

    Faults compose from outside: ``run_federated(faults=...)``.
    """

    name = "async"

    def __init__(self, buffer_size: Optional[int] = None,
                 staleness: str = "polynomial", staleness_a: float = 0.5,
                 staleness_cutoff: Optional[float] = None,
                 profile=None, availability=None,
                 inner="auto", base_step_time: float = 1.0,
                 pipelined: bool = True,
                 wave_slots: "int | str | None" = "auto"):
        from repro_torch.core.server import STALENESS_SCHEMES
        if staleness not in STALENESS_SCHEMES:
            raise ValueError(f"unknown staleness scheme {staleness!r}; "
                             f"available: {STALENESS_SCHEMES}")
        if isinstance(inner, str) and inner == "async":
            raise ValueError("AsyncExecutor cannot nest itself as inner")
        if isinstance(wave_slots, str) and wave_slots not in ("auto",
                                                              "variable"):
            raise ValueError(f"wave_slots must be 'auto', 'variable', an "
                             f"int or None, got {wave_slots!r}")
        if isinstance(wave_slots, int) and wave_slots < 1:
            raise ValueError(f"wave_slots must be >= 1, got {wave_slots}")
        self.buffer_size = buffer_size
        self.staleness = staleness
        self.staleness_a = staleness_a
        self.staleness_cutoff = staleness_cutoff
        self.profile = profile
        self.availability = availability
        self.inner = inner
        self.base_step_time = base_step_time
        self.pipelined = pipelined
        self.wave_slots = wave_slots

    def resolve_inner(self, algo: Algorithm, n_sample: int,
                      model: Optional[ModelBundle] = None):
        resolved = get_executor(self.inner, algo, n_sample, model)
        if isinstance(resolved, AsyncExecutor):
            raise ValueError("AsyncExecutor cannot nest itself as inner")
        return resolved

    def resolve_wave_slots(self, buffer_size: int, inner) -> Optional[int]:
        """The reference's fixed slot count: ``None`` for "variable", None
        or a sequential inner, the buffer size for "auto", else the int."""
        if self.wave_slots in (None, "variable"):
            return None
        if getattr(inner, "name", None) == "sequential":
            return None
        return buffer_size if self.wave_slots == "auto" else self.wave_slots

    def run_round(self, ctx, global_params, payload, client_states,
                  client_data, rng, client_ids=None) -> RoundResult:
        raise NotImplementedError(
            "AsyncExecutor rounds are event-driven, not cohort-at-a-time; "
            "drive it through run_federated(..., executor=\"async\")")


_EXECUTORS = {"sequential": SequentialExecutor, "vmap": VmapExecutor,
              "shard_map": ShardMapExecutor, "async": AsyncExecutor}


def available() -> list[str]:
    return sorted(_EXECUTORS) + ["auto"]


def get_executor(spec, algo: Algorithm, n_sample: int,
                 model: Optional[ModelBundle] = None):
    """Resolve an executor spec.  ``"auto"`` picks the vmap executor when
    the algorithm ``supports_vmap``, more than one client is sampled and
    the model batches well: it is ``vmap_friendly`` (the MLP: the vmapped
    round body), or it is ``client_batched`` and the algorithm has a
    ``batched_loss_fn`` (ResNet-8/50: the client-batched route); the
    sequential executor otherwise.  Instances pass through."""
    if not isinstance(spec, str):
        return spec
    if spec == "auto":
        model_ok = (model is None or model.vmap_friendly
                    or (model.client_batched
                        and algo.batched_loss_fn(model) is not None))
        batched_ok = algo.supports_vmap and n_sample > 1 and model_ok
        spec = "vmap" if batched_ok else "sequential"
    if spec in _EXECUTORS:
        return _EXECUTORS[spec]()
    raise ValueError(f"unknown executor {spec!r}; available: {available()}")
