"""Client execution: how one round's sampled clients are trained.

Two of the reference's executors (``repro.core.executor``):

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

``AsyncExecutor`` — buffered-asynchronous rounds on a simulated
heterogeneous system: the configuration and the inner executor that trains
each dispatch wave; the event loop is ``fl_loop._run_async``.

``executor="auto"`` picks the vmap executor for more than one sampled
client of a ``vmap_friendly`` model (the MLP) or of a client-batched pair,
the sequential executor otherwise (the text encoder; ResNet-8 with MOON,
FedDistill+, SCAFFOLD, FedDyn or FedGen).  The shard_map executor is not
ported yet; asking for it raises.
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
    the device; the loop reads the losses at aggregation."""
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
    sel = materialize_picks(rng, data, batch_size, epochs, max_batches)
    return MaterializedClient(data.x[sel], data.y[sel], data.n, sel)


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
                  client_ids=None) -> RoundResult:
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
        mats = [materialize_client(rng, d, ctx.batch_size, ctx.epochs,
                                   ctx.max_batches) for d in client_data]
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
              "async": AsyncExecutor}
_NOT_PORTED = {"shard_map": "ROADMAP A8b and A13"}


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
    if spec in _NOT_PORTED:
        raise NotImplementedError(
            f"executor {spec!r} is not ported yet ({_NOT_PORTED[spec]})")
    raise ValueError(f"unknown executor {spec!r}; available: {available()}")
