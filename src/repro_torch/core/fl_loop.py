"""Algorithm-agnostic federated training loop (Alg. 1 ServerExecution).

The port of ``repro.core.fl_loop.run_federated``: per round, sample the
cohort, build the broadcast payload, train the cohort through the
executor, aggregate, evaluate; with ``executor="async"`` the buffered
asynchronous loop (``_run_async``) instead.  Around the rounds: DP clipping
and noise (``core.privacy``), fault injection with quorum, validation and
retries (``core.systemsim``, ``core.server``), and checkpoint/resume of
the full run state (``checkpoint.recovery``).  With ``population=`` (a
``repro_torch.population.Population``) in place of ``data=``, clients come
through the population tier: cohorts from its O(cohort) sampler, shards
through its warm cache, per-client states from its state store, so nothing
in the loop is O(population).  With a population placed over several
hosts (``HostPlacement(h, n_hosts > 1)``) every host replays the whole
simulation (cohorts, batch picks, fault draws, the async event heap) and
trains only the clients it owns; the uploads cross a filesystem exchange
(``population.placement``) and every host aggregates the same inputs, so
the hosts agree bit for bit (``_multihost_round``,
``_multihost_fault_round``, ``_multihost_wave``).  The numpy generator is
consumed in the reference's order and count (cohort draw, then each
client's batch picks), so one seed samples the same cohorts and batches in
both packages; the simulator and the fault injector draw from their own
child streams of the seed, as the reference's do.

Runs on ``"cuda"`` unless the caller passes ``device="cpu"``; without a card
and without that argument it raises rather than fall back.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import recovery
from repro_torch.configs.paper import PaperTask
from repro_torch.core import executor as executor_lib
from repro_torch.core import privacy, systemsim
from repro_torch.core.algorithms import Algorithm, FedGen
from repro_torch.core.distillation import accuracy, cross_entropy
from repro_torch.core.modelzoo import ModelBundle, make_model
from repro_torch.core.server import (FaultPolicy, async_aggregation_weights,
                                     validate_update)
from repro_torch.data.pipeline import FederatedData, num_batches
from repro_torch.data.synthetic import make_task_data
from repro_torch.optim import adam, sgd
from repro_torch.population import placement as placement_lib
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class RoundRecord:
    round: int
    test_acc: float
    test_loss: float
    mean_local_loss: float
    seconds: float
    # the async loop's (a synchronous round keeps the defaults)
    sim_time: float = 0.0        # virtual clock at this aggregation
    version: int = 0             # global model version after the update
    mean_staleness: float = 0.0  # mean (version - start version) in buffer
    sampled: tuple = ()          # client ids of the round's cohort (async:
    #                              of the aggregated buffer)


@dataclasses.dataclass
class History:
    algo: str
    records: list[RoundRecord]
    final_params: Any
    local_model_acc: float = 0.0       # last sampled client's local-model acc
    telemetry: dict = dataclasses.field(default_factory=dict)

    @property
    def best_acc(self) -> float:
        return max(r.test_acc for r in self.records)

    @property
    def final_acc(self) -> float:
        return self.records[-1].test_acc

    def accs(self) -> list[float]:
        return [r.test_acc for r in self.records]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is absent and the caller
    did not ask for the CPU: nothing falls back silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    return dev


def evaluate(model: ModelBundle, params: Any, x: np.ndarray, y: np.ndarray,
             batch: int = 256) -> tuple[float, float]:
    """(accuracy, mean CE) over a test set, ``batch`` rows per forward, the
    per-batch values read back once."""
    device = tree_leaves(params)[0].device
    stats, ns = [], []
    with torch.no_grad():
        for i in range(0, len(y), batch):
            xb = torch.from_numpy(np.ascontiguousarray(x[i:i + batch])).to(device)
            yb = torch.from_numpy(np.asarray(y[i:i + batch])).to(device)
            logits = model.apply(params, xb)
            stats.append(torch.stack([accuracy(logits, yb),
                                      cross_entropy(logits, yb)]))
            ns.append(len(yb))
        read = torch.stack(stats).tolist()
    n = sum(ns)
    return (sum(a * k for (a, _), k in zip(read, ns)) / n,
            sum(c * k for (_, c), k in zip(read, ns)) / n)


def run_federated(task: PaperTask, algo: Algorithm,
                  data: Optional[FederatedData] = None, *,
                  population=None, rounds: Optional[int] = None,
                  seed: int = 0, eval_every: int = 1,
                  max_batches_per_client: Optional[int] = None,
                  verbose: bool = False, width: int = 16,
                  round_callback=None, dp=None, executor="auto",
                  precompute="auto", client_batched="auto",
                  faults=None, fault_policy=None,
                  checkpoint_dir: Optional[str] = None,
                  checkpoint_every: int = 1, resume: bool = False,
                  device=None) -> History:
    """Run T communication rounds of ``algo`` on the partitioned data.

    The arguments mean what they mean in the reference; ``data`` holds
    images, tabular rows or int32 token sequences, and ``width`` is
    ResNet-8's and the MLP's (the text encoder takes its width from the
    task, ResNet-50 has none).  ``eval_every``: the test set is evaluated
    every that many rounds and after the last; the rounds between repeat
    the last evaluation (0.0 before the first).  ``verbose`` prints the
    executor's route after round 1 and one line a round.  ``precompute``:
    the round-level teacher-precompute stage; ``"auto"`` turns it on
    unless the executor that trains the clients is the sequential one.
    ``client_batched``: the vmap executor's client-batched round body
    (``"auto"``, ``True`` or ``False``, which forces the vmapped body; see
    ``executor.RoundContext``).

    ``executor``: ``"sequential"``, ``"vmap"``, ``"shard_map"`` (the
    cohort split into one slice per card, client shards resident on the
    cards: ``executor.ShardMapExecutor``), ``"async"`` or an
    ``executor.AsyncExecutor(...)`` (buffered asynchronous aggregation on
    a simulated heterogeneous system, see ``_run_async``; its records
    carry ``sim_time``, ``version`` and ``mean_staleness``), another
    executor instance, or ``"auto"``.

    ``dp=`` (a ``privacy.DPConfig``): every upload's delta is clipped and
    the aggregate noised.  ``faults=`` (a ``systemsim.FaultProfile``):
    per-dispatch crash / timeout / corrupt draws from the fault stream,
    ``server.validate_update`` on every upload, quorum aggregation with
    capped-backoff retries (``fault_policy=``, a ``server.FaultPolicy``)
    and the counters in ``History.telemetry["faults"]``; a
    zero-probability profile is bit-identical to ``faults=None``.
    ``checkpoint_dir=`` saves the full run state every ``checkpoint_every``
    rounds and after the last (the async loop's simulator with its
    in-flight uploads included); ``resume=True`` restores the newest
    loadable state there (torn files skipped) and continues as the
    uninterrupted run would.

    ``population=`` (a ``repro_torch.population.Population``) takes the
    place of ``data=``; exactly one of the two is given.  The cohort is
    pinned in the population's tiers while it trains (in the async loop,
    while it is in flight), ``History.telemetry["population"]`` holds the
    tiers' counters, and a checkpoint holds the state store's snapshot
    (warm states by value, spills by reference) instead of every client's
    state.  A population whose placement spans several hosts trains only
    this host's shards and exchanges the uploads with its peers (one
    ``run_federated`` per host, each with its ``HostPlacement``); its
    checkpoints are ``state_hostNNN_*`` files, a resume first agrees with
    the peers on the round to restore (``placement.resume_barrier``), and
    ``FaultProfile.host_crash_prob`` crashes whole hosts, whose slices then
    fail as a block.  It does not compose with ``dp=``.  ``device``
    defaults to ``"cuda"``.
    """
    if (data is None) == (population is None):
        raise ValueError("pass exactly one of data= (a FederatedData) or "
                         "population= (a repro_torch.population.Population)")
    pop = population
    if pop is not None:
        data = pop      # it answers clients[cid], test_x, sample_cohort, ...
    multihost = pop is not None and getattr(pop, "multihost", False)
    dev = resolve_device(device)
    rounds = rounds if rounds is not None else task.rounds
    model = make_model(task, projection_head=algo.needs_projection_head,
                       width=width)
    rng = np.random.default_rng(seed)
    # the init is drawn on the CPU, so one seed gives one init on any device
    init_gen = torch.Generator().manual_seed(seed + 1)
    global_params = tree_map(lambda t: t.to(dev), model.init(init_gen))
    # client 0 is read for every algorithm, as the reference reads it, so
    # a population's tier counters equal the reference's; a host that does
    # not own it reads it from the cold source, past its warm tier
    probe = pop.probe_client() if multihost else data.clients[0]
    if isinstance(algo, FedGen):
        probe_x = torch.from_numpy(probe.x[:2]).to(dev)
        server = algo.init_server_with_probe(global_params, model,
                                             task.num_classes, probe_x)
    else:
        server = algo.init_server(global_params, model, task.num_classes)
    if rounds == 0:
        return History(algo.name, [], server["global"], 0.0)

    if task.optimizer == "adam":
        opt = adam(weight_decay=task.weight_decay)
    else:
        opt = sgd(momentum=task.momentum, weight_decay=task.weight_decay)

    n_sample = max(1, int(round(task.participation * data.n_clients)))
    exec_ = executor_lib.get_executor(executor, algo, n_sample, model)
    inner = None
    if isinstance(exec_, executor_lib.AsyncExecutor):
        inner = exec_.resolve_inner(algo, n_sample, model)
    if precompute == "auto":
        precompute = (inner or exec_).name != "sequential"
    ctx = executor_lib.RoundContext(
        algo=algo, model=model, opt=opt, lr=task.lr,
        batch_size=task.batch_size, epochs=task.local_epochs, device=dev,
        max_batches=max_batches_per_client, precompute=bool(precompute),
        client_batched=client_batched)
    if multihost:
        if dp is not None:
            raise NotImplementedError(
                "multi-host placement does not compose with dp= yet")
        # this host's devices must never materialize an unowned slab
        ctx.placement.owns = pop.owned
    if pop is not None:
        # warm evictions drop device slabs, slab evictions count into the
        # population's telemetry, the pinned set is shared
        pop.attach_hot(ctx.placement)
        # the lazy state store: the eager dict below is a model copy per
        # client for the stateful algorithms
        client_states = pop.make_client_states(algo, global_params)
    else:
        client_states = {k: algo.init_client_state(k, global_params)
                         for k in range(data.n_clients)}
    # a small server-side validation split: FedGKD-VOTE's coefficients
    n_val = min(256, len(data.test_y) // 4)
    val_batch = (torch.from_numpy(np.ascontiguousarray(data.test_x[:n_val]))
                 .to(dev), torch.from_numpy(np.asarray(data.test_y[:n_val]))
                 .to(dev))

    injector = policy = None
    if faults is not None:
        injector = systemsim.FaultInjector(faults,
                                           systemsim.derive_fault_rng(seed))
        policy = fault_policy if fault_policy is not None else FaultPolicy()
        ctx.telemetry["faults"] = _fault_counters(policy)

    if resume and checkpoint_dir is None:
        raise ValueError("resume=True requires checkpoint_dir=")

    if inner is not None:
        return _run_async(algo, data, model, server, ctx, exec_, inner,
                          rng, seed=seed, rounds=rounds,
                          eval_every=eval_every, verbose=verbose,
                          round_callback=round_callback, dp=dp,
                          n_sample=n_sample, client_states=client_states,
                          val_batch=val_batch, injector=injector,
                          policy=policy, checkpoint_dir=checkpoint_dir,
                          checkpoint_every=checkpoint_every, resume=resume,
                          pop=pop)

    records: list[RoundRecord] = []
    uploads: list[dict] = []
    ckpt_host = pop.placement.host_id if multihost else None
    dead_hosts: set = set()     # peers that missed an exchange deadline
    start_round = 0
    if resume:
        hit = recovery.load_latest_state(checkpoint_dir, device=dev,
                                         host=ckpt_host)
        if multihost:
            hit = _agreed_restore(pop.placement, checkpoint_dir, hit, dev)
        if hit is not None:
            state, meta, start_round = hit
            server, records = _restore_run(state, meta, algo, rng, injector,
                                           ctx, client_states)
        if multihost:
            _confirm_restore(pop.placement, hit, start_round,
                             {"algo": algo.name})

    for t in range(start_round, rounds):
        t0 = time.time()
        sampled = data.sample_cohort(rng, n_sample)
        payload = algo.round_payload(server)
        cids = [int(k) for k in sampled]
        if multihost and injector is not None:
            # a crashed or silent host is a fault over its whole slice;
            # the quorum counts the surviving hosts' validated uploads
            uploads, weights, local_losses = _multihost_fault_round(
                exec_, ctx, pop, server, payload, client_states, rng, cids,
                injector, policy, t, dead_hosts)
        elif multihost:
            uploads, weights, local_losses = _multihost_round(
                ctx, exec_, pop, server["global"], payload, client_states,
                cids, rng, t)
        else:
            if pop is not None:
                # the cohort must not evict itself from the tiers while it
                # is materialized and trained
                pop.pin(cids)
            if injector is None:
                result = exec_.run_round(
                    ctx, server["global"], payload,
                    [client_states[k] for k in cids],
                    [data.clients[k] for k in cids], rng, client_ids=cids)
                uploads, weights = result.uploads, result.weights
                local_losses = result.local_losses
                for k, new_state in zip(cids, result.client_states):
                    client_states[k] = new_state
            else:
                uploads, weights, local_losses = _fault_tolerant_round(
                    exec_, ctx, server, payload, client_states, data, rng,
                    cids, injector, policy)
        if verbose and t == start_round:
            print(f"[{algo.name}] executor route: "
                  f"{ctx.telemetry.get('route', exec_.name)}")
        if pop is not None and not multihost:
            pop.unpin(cids)
            ctx.telemetry["population"] = pop.stats()

        if not uploads:
            # every client of the cohort crashed or was rejected through
            # all retries: hold the global rather than aggregate nothing
            ctx.telemetry["faults"]["skipped_rounds"] += 1
        else:
            server, uploads = _aggregate(algo, server, uploads, weights,
                                         model, val_batch, data.n_clients,
                                         dp, t)

        if (t + 1) % eval_every == 0 or t == rounds - 1:
            acc, loss = evaluate(model, server["global"], data.test_x,
                                 data.test_y)
        else:
            acc, loss = ((records[-1].test_acc, records[-1].test_loss)
                         if records else (0.0, 0.0))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        records.append(RoundRecord(
            t + 1, acc, loss,
            float(np.mean(local_losses)) if local_losses else 0.0,
            time.time() - t0, sampled=tuple(cids)))
        if checkpoint_dir is not None and (
                (t + 1) % checkpoint_every == 0 or t == rounds - 1):
            _save_checkpoint(checkpoint_dir, t + 1, algo, server, rng,
                             injector, records, client_states,
                             data.n_clients, ftel=ctx.telemetry.get("faults"),
                             host=ckpt_host)
        if round_callback is not None:
            round_callback(t + 1, server, model)
        if verbose:
            print(f"[{algo.name}] round {t + 1:3d}/{rounds} acc={acc:.4f} "
                  f"loss={loss:.4f} local={np.mean(local_losses):.4f}")

    # paper Fig.2-style: accuracy of the last trained LOCAL model
    local_acc = 0.0
    if uploads:
        local_acc, _ = evaluate(model, uploads[-1]["params"], data.test_x,
                                data.test_y)
    if injector is not None:
        ctx.telemetry["faults"].update(injector.counters)
    return History(algo.name, records, server["global"], local_acc,
                   dict(ctx.telemetry))


def _aggregate(algo, server, uploads, weights, model, val_batch, n_clients,
               dp, t):
    """``server_update`` on the uploads, with DP's clipping before it and
    its noise after it when ``dp`` is given; returns the server and the
    uploads it aggregated (clipped under DP)."""
    if dp is not None:
        uploads = privacy.privatize_uploads(uploads, server["global"], dp, t)
    server = algo.server_update(server, uploads, weights, model, val_batch,
                                n_clients=n_clients)
    if dp is not None:
        server["global"] = privacy.noise_aggregate(server["global"], dp,
                                                   len(uploads), t)
    return server, uploads


def _fault_counters(policy: FaultPolicy) -> dict:
    """The zeroed ``History.telemetry["faults"]``; the injector's counters
    merge in at the end of the run."""
    return {"crashes": 0, "timeouts": 0, "corrupt_injected": 0,
            "rejected_nonfinite": 0, "rejected_norm": 0,
            "retries": 0, "redispatches": 0, "backoff_wait": 0.0,
            "quorum_shortfalls": 0, "skipped_rounds": 0,
            "dropped_clients": 0, "quorum_frac": policy.quorum_frac,
            "host_crashes": 0, "host_timeouts": 0}


def _fault_tolerant_round(exec_, ctx, server, payload, client_states, data,
                          rng, cids, injector, policy):
    """One synchronous round under fault injection: train the cohort, draw
    a fault per dispatch, gate survivors through ``validate_update``, and
    retry the failed subset (capped exponential backoff on the virtual
    clock) until ``quorum_frac`` of the cohort survives or the retries run
    out.  Returns ``(uploads, weights, local_losses)`` of the survivors in
    cohort order; only survivors commit their client state."""
    ftel = ctx.telemetry["faults"]
    quorum = max(1, int(np.ceil(policy.quorum_frac * len(cids))))
    uploads: list[dict] = []
    weights: list[float] = []
    losses: list[float] = []
    state_commits: dict = {}
    pending = list(cids)
    attempt = 0
    while pending:
        drawn = [(k, injector.draw()) for k in pending]
        # a crash or timeout never arrives: nothing to train for
        failed = [k for k, f in drawn
                  if f is not None and f[0] in ("crash", "timeout")]
        alive = [(k, f) for k, f in drawn if f is None or f[0] == "corrupt"]
        if alive:
            ids = [k for k, _ in alive]
            result = exec_.run_round(
                ctx, server["global"], payload,
                [client_states[k] for k in ids],
                [data.clients[k] for k in ids], rng, client_ids=ids)
            for i, (k, f) in enumerate(alive):
                up = result.uploads[i]
                if f is not None:
                    up = dict(up, params=systemsim.corrupt_params(
                        up["params"], f[1], injector.profile.huge_scale))
                ok, reason = validate_update(
                    up["params"], server["global"],
                    max_norm_mult=policy.max_norm_mult)
                if ok:
                    uploads.append(up)
                    weights.append(result.weights[i])
                    losses.append(result.local_losses[i])
                    state_commits[k] = result.client_states[i]
                else:
                    ftel["rejected_nonfinite" if reason.startswith("nonfinite")
                         else "rejected_norm"] += 1
                    failed.append(k)
        if len(uploads) >= quorum or not failed \
                or attempt >= policy.max_retries:
            break
        # redispatch the failed subset after the backoff, from the same
        # round-frozen payload against the current global
        attempt += 1
        ftel["retries"] += 1
        ftel["redispatches"] += len(failed)
        ftel["backoff_wait"] += policy.backoff(attempt)
        pending = failed
    if len(uploads) < quorum:
        ftel["quorum_shortfalls"] += 1
    for k, s in state_commits.items():
        client_states[k] = s
    return uploads, weights, losses


def _save_checkpoint(ckpt_dir, rnd, algo, server, rng, injector, records,
                     client_states, n_clients, ftel=None, extra=None,
                     host=None):
    state = {
        "server": server,
        "np_rng": recovery.rng_state(rng),
        "fault_rng": (recovery.rng_state(injector.rng)
                      if injector is not None else None),
        # the counters travel with the stream, so a resumed run's fault
        # telemetry is the uninterrupted run's, not only the tail's
        "fault_counters": (dict(injector.counters)
                           if injector is not None else None),
        "fault_telemetry": dict(ftel) if ftel is not None else None,
        "records": [dataclasses.asdict(r) for r in records],
        "client_states": _snapshot_client_states(client_states, n_clients),
    }
    if extra:
        state.update(extra)
    recovery.save_run_state(ckpt_dir, rnd, state, meta={"algo": algo.name},
                            host=host)


def _snapshot_client_states(client_states, n_clients):
    """The checkpoint's per-client states: the eager dict's every state by
    value; a population's ``ClientStateStore`` snapshots itself (warm
    states by value, spills by reference, nothing for a stateless
    algorithm), so the checkpoint is O(touched clients)."""
    if hasattr(client_states, "snapshot"):
        return client_states.snapshot()
    return [client_states[k] for k in range(n_clients)]


def _restore_client_states(client_states, saved) -> None:
    if hasattr(client_states, "restore") and isinstance(saved, dict):
        client_states.restore(saved)
        return
    if isinstance(saved, dict):
        raise ValueError(
            "the checkpoint holds a population state-store snapshot but "
            "this run uses data=: resume with the population= it was "
            "written under")
    for k, s in enumerate(saved):
        client_states[k] = s


def _restore_run(state, meta, algo, rng, injector, ctx, client_states):
    """Put a loaded run state back in place: the rng streams, the fault
    counters and telemetry, the client states; returns ``(server,
    records)``.  A checkpoint of another algorithm is refused."""
    if meta.get("algo") not in (None, algo.name):
        raise ValueError(f"resume: checkpoint was written by algo "
                         f"{meta.get('algo')!r}, this run is {algo.name!r}")
    recovery.restore_rng(rng, state["np_rng"])
    if injector is not None and state.get("fault_rng") is not None:
        recovery.restore_rng(injector.rng, state["fault_rng"])
        if state.get("fault_counters") is not None:
            injector.counters.update(state["fault_counters"])
        if state.get("fault_telemetry") is not None:
            ctx.telemetry["faults"].update(state["fault_telemetry"])
    _restore_client_states(client_states, state["client_states"])
    return state["server"], [RoundRecord(**d) for d in state["records"]]


def _agreed_restore(placement, ckpt_dir, hit, device):
    """The coordinated resume's restore point: the newest round every host
    can load (the minimum over the hosts, ``placement.resume_barrier``),
    this host's state at that round, or ``None`` when all start fresh."""
    common = placement_lib.resume_barrier(
        placement, hit[2] if hit is not None else None)
    if common is None:
        return None
    if hit is None or hit[2] != common:
        hit = (*recovery.load_state_at(ckpt_dir, common, device=device,
                                       host=placement.host_id), common)
    return hit


def _confirm_restore(placement, hit, start_round, meta: dict) -> None:
    """Retire this host's stale exchange files, then check that every
    host restored the same state (``meta`` and the round) before the
    first round runs."""
    common = None if hit is None else start_round
    placement_lib.clear_host_payloads(placement)
    placement_lib.confirm_resume(placement, common,
                                 {"round": common, **meta})


class _SizeOnly:
    """``materialize_picks`` reads only ``.n``: every host draws the whole
    cohort's batch picks from the client sizes alone (``client_n``
    materializes nothing), keeping the generator in lockstep."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = int(n)


def _cohort_picks(ctx, pop, rng, cids) -> list[np.ndarray]:
    """Every client's batch picks in cohort order, as a one-host executor
    would draw them."""
    return [executor_lib.materialize_picks(
        rng, _SizeOnly(pop.client_n(c)), ctx.batch_size, ctx.epochs,
        ctx.max_batches) for c in cids]


def _host_stats(ctx, pop) -> dict:
    """This host's tier, slab-store and exchange counters, for its peers."""
    return dict(pop.stats(), host_rss_mb=placement_lib.peak_rss_mb(),
                slab=ctx.placement.stats(), exchange=dict(pop.placement.stats))


def _gathered_uploads(gathered) -> dict:
    """``{cohort index: (upload, weight, loss)}`` from the live hosts'
    payloads."""
    got = {}
    for g in gathered:
        if g is None or g.get("crashed"):
            continue
        for jj, j in enumerate(g["idx"]):
            got[int(j)] = (g["uploads"][jj], float(g["weights"][jj]),
                           float(g["losses"][jj]))
    return got


def _train_owned(exec_, ctx, pop, global_params, payload, client_states,
                 ids, picks, rng,
                 in_flight: bool = False) -> tuple[dict, dict]:
    """Train this host's clients ``ids`` with their pre-drawn ``picks``,
    pinned in the tiers meanwhile (``in_flight``: left pinned, for the
    async loop to release at completion); returns the exchange payload's
    training part and the new states."""
    pop.pin(ids)
    result = exec_.run_round(
        ctx, global_params, payload, [client_states[k] for k in ids],
        [pop.clients[k] for k in ids], rng, client_ids=ids, picks=picks)
    if not in_flight:
        pop.unpin(ids)
    return ({"uploads": result.uploads,
             "weights": [float(w) for w in result.weights],
             "losses": [float(v) for v in result.local_losses]},
            dict(zip(ids, result.client_states)))


def _multihost_round(ctx, exec_, pop, global_params, payload, client_states,
                     cids, rng, t):
    """One synchronous round under multi-host placement.

    Every host arrives with the same generator, payload and cohort (the
    sampler draws in lockstep).  Each draws the batch picks of the whole
    cohort in cohort order (consuming the generator as a one-host executor
    would), trains only the clients it owns, publishes their uploads
    through the filesystem allgather, and rebuilds the full upload list in
    cohort order from every host's payload (its own read back from its
    file, so all hosts aggregate byte-identical inputs).  The hosts' tier
    counters land in ``telemetry["population"]["hosts"]``, by host id."""
    own_idx = [i for i, c in enumerate(cids) if pop.owned(c)]
    own_cids = [cids[i] for i in own_idx]
    picks_all = _cohort_picks(ctx, pop, rng, cids)
    local: dict = {"idx": own_idx, "uploads": [], "weights": [],
                   "losses": []}
    if own_cids:            # a host that owns nobody still publishes
        trained, new_states = _train_owned(
            exec_, ctx, pop, global_params, payload, client_states, own_cids,
            [picks_all[i] for i in own_idx], rng)
        local.update(trained)
        for k, st in new_states.items():
            client_states[k] = st
    local["stats"] = _host_stats(ctx, pop)
    gathered = placement_lib.allgather(pop.placement, f"round{t:06d}", local,
                                       device=ctx.device)
    got = _gathered_uploads(gathered)
    missing = [c for i, c in enumerate(cids) if i not in got]
    if missing:
        raise RuntimeError(
            f"multi-host round {t}: no host owned clients "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''}: the "
            f"placement does not partition the cohort")
    ctx.telemetry["population"] = dict(
        pop.stats(), hosts=[g["stats"] for g in gathered])
    return ([got[i][0] for i in range(len(cids))],
            [got[i][1] for i in range(len(cids))],
            [got[i][2] for i in range(len(cids))])


def _exchange_wave(pop, tag, local, injector, dead_hosts, ftel, device):
    """Allgather one round attempt's or wave's payload.  With fault
    injection a peer that misses the deadline joins ``missing`` instead of
    raising (crash-stop: every survivor resolves the same set) and is
    never polled for again (``dead_hosts``); without it the exchange stays
    strict: a dead peer is an error, not a fault to tolerate."""
    pl = pop.placement
    if injector is None:
        return placement_lib.allgather(pl, tag, local, device=device), ()
    gathered, missing = placement_lib.allgather_partial(
        pl, tag, local, skip_wait=dead_hosts, device=device)
    new = [h for h in missing if h not in dead_hosts]
    if new:
        ftel["host_timeouts"] += len(new)
        dead_hosts.update(new)
    return gathered, missing


def _owner_is_down(pop, cid, crashed, gathered) -> bool:
    """Did the host that owns ``cid`` crash (drawn) or go silent?  A live
    owner that published nothing for it is a placement bug: False."""
    owner = pop.sampler.shard_of(int(cid)) % pop.placement.n_hosts
    g = gathered[owner]
    return owner in crashed or g is None or bool(g["crashed"])


def _multihost_fault_round(exec_, ctx, pop, server, payload, client_states,
                           rng, cids, injector, policy, t, dead_hosts):
    """``_fault_tolerant_round`` under multi-host placement.

    Every host replays the full fault and pick draws (the streams in
    lockstep), trains only the live clients it owns, and exchanges the
    results per attempt (tag ``roundTTTTTTaAA``).  A crashed host (drawn
    from ``FaultProfile.host_crash_prob``, one uniform per host in host
    order each attempt, or a peer that misses the deadline) fails its whole
    slice as a block; the quorum counts the surviving hosts' validated
    uploads and the retries redispatch the missing slice.  Uploads cross
    the exchange clean and every host replays the corruption draw
    (``corrupt_params`` is pure, ``validate_update`` deterministic), so all
    survivors accept and reject the same updates.  With
    ``host_crash_prob == 0`` and no missed deadline this is the one-host
    round's result."""
    pl = pop.placement
    ftel = ctx.telemetry["faults"]
    quorum = max(1, int(np.ceil(policy.quorum_frac * len(cids))))
    uploads: list = []
    weights: list = []
    losses: list = []
    state_commits: dict = {}
    host_stats = None
    pending = list(cids)
    attempt = 0
    while pending:
        crashed = ()
        if injector.profile.host_crash_prob > 0.0:
            crashed = injector.draw_host_crashes(pl.n_hosts)
        drawn = [(k, injector.draw()) for k in pending]
        failed = [k for k, f in drawn
                  if f is not None and f[0] in ("crash", "timeout")]
        alive = [(k, f) for k, f in drawn if f is None or f[0] == "corrupt"]
        alive_ids = [k for k, _ in alive]
        picks = _cohort_picks(ctx, pop, rng, alive_ids)
        own = [(j, k) for j, k in enumerate(alive_ids) if pop.owned(k)]
        local: dict = {"idx": [], "uploads": [], "weights": [], "losses": [],
                       "crashed": pl.host_id in crashed}
        new_states: dict = {}
        if own and not local["crashed"]:
            trained, new_states = _train_owned(
                exec_, ctx, pop, server["global"], payload, client_states,
                [k for _, k in own], [picks[j] for j, _ in own], rng)
            local.update(trained, idx=[j for j, _ in own])
        local["stats"] = _host_stats(ctx, pop)
        gathered, _ = _exchange_wave(
            pop, f"round{t:06d}a{attempt:02d}", local, injector, dead_hosts,
            ftel, ctx.device)
        host_stats = [g["stats"] if g is not None else None
                      for g in gathered]
        got = _gathered_uploads(gathered)
        for j, (k, f) in enumerate(alive):
            hit = got.get(j)
            if hit is None:
                if _owner_is_down(pop, k, crashed, gathered):
                    failed.append(k)        # a host fault over its slice
                    continue
                raise RuntimeError(
                    f"multi-host fault round {t}: a live host published no "
                    f"upload for client {k}: the placement does not "
                    f"partition the cohort")
            up, w, lv = hit
            if f is not None:
                up = dict(up, params=systemsim.corrupt_params(
                    up["params"], f[1], injector.profile.huge_scale))
            ok, reason = validate_update(up["params"], server["global"],
                                         max_norm_mult=policy.max_norm_mult)
            if ok:
                uploads.append(up)
                weights.append(w)
                losses.append(lv)
                if k in new_states:
                    state_commits[k] = new_states[k]
            else:
                ftel["rejected_nonfinite" if reason.startswith("nonfinite")
                     else "rejected_norm"] += 1
                failed.append(k)
        if len(uploads) >= quorum or not failed \
                or attempt >= policy.max_retries:
            break
        attempt += 1
        ftel["retries"] += 1
        ftel["redispatches"] += len(failed)
        ftel["backoff_wait"] += policy.backoff(attempt)
        pending = failed
    if len(uploads) < quorum:
        ftel["quorum_shortfalls"] += 1
    for k, st in state_commits.items():
        client_states[k] = st
    ctx.telemetry["population"] = dict(pop.stats(), hosts=host_stats)
    return uploads, weights, losses


def _multihost_wave(ctx, inner, pop, global_params, payload, client_states,
                    cids, rng, tag, injector, dead_hosts, ftel):
    """One async dispatch wave under multi-host placement.

    Every host replays the whole simulation (sampling, the event heap, the
    aggregations); only the training is split.  Each host draws the whole
    wave's batch picks, then the wave's host crashes (one uniform per host
    when ``host_crash_prob > 0``), trains the owned clients if it is
    alive, publishes them under the wave's ``tag`` and reassembles the
    wave.  The returned ``(upload, weight, loss, fault)`` per client is
    byte-identical on every host, so the simulators' heaps stay in
    lockstep with no other coordination.  A crashed or silent host gives
    each client of its slice the fault ``("host_crash", "")``: the
    dispatch occupies the heap with no upload and fails at the buffer
    fill, whose retries redispatch it.  Returns the per-client results and
    the hosts' stats."""
    pl = pop.placement
    crashed = ()
    if injector is not None and injector.profile.host_crash_prob > 0.0:
        crashed = injector.draw_host_crashes(pl.n_hosts)
    picks = _cohort_picks(ctx, pop, rng, cids)
    own = [(i, c) for i, c in enumerate(cids) if pop.owned(c)]
    local: dict = {"idx": [], "uploads": [], "weights": [], "losses": [],
                   "crashed": pl.host_id in crashed}
    new_states: dict = {}
    if own and not local["crashed"]:
        trained, new_states = _train_owned(
            inner, ctx, pop, global_params, payload, client_states,
            [c for _, c in own], [picks[i] for i, _ in own], rng,
            in_flight=True)
        local.update(trained, idx=[i for i, _ in own])
    local["stats"] = _host_stats(ctx, pop)
    gathered, _ = _exchange_wave(pop, tag, local, injector, dead_hosts, ftel,
                                 ctx.device)
    # the per-client fault draws after training, in wave order: the
    # one-host launch's consumption of the fault stream
    per_fault = [injector.draw() if injector is not None else None
                 for _ in cids]
    got = _gathered_uploads(gathered)
    out = []
    for i, c in enumerate(cids):
        hit = got.get(i)
        if hit is None:
            if _owner_is_down(pop, c, crashed, gathered):
                out.append((None, 0.0, 0.0, ("host_crash", "")))
                continue
            raise RuntimeError(
                f"multi-host wave {tag}: a live host published no upload "
                f"for client {c}: the placement does not partition the "
                f"wave")
        up, w, lv = hit
        if per_fault[i] is None and c in new_states:
            # a healthy dispatch commits its owned client's state
            client_states[c] = new_states[c]
        out.append((up, w, lv, per_fault[i]))
    return out, [g["stats"] if g is not None else None for g in gathered]


def _read_losses(values: list) -> list[float]:
    """Per-client losses as host floats; a deferred wave's device tensors
    in one read back."""
    if values and all(isinstance(v, torch.Tensor) for v in values):
        return torch.stack(values).cpu().tolist()
    return [float(v) for v in values]


def _run_async(algo: Algorithm, data: FederatedData,
               model: ModelBundle, server: dict,
               ctx: "executor_lib.RoundContext",
               exec_: "executor_lib.AsyncExecutor", inner,
               rng: np.random.Generator, *, seed: int, rounds: int,
               eval_every: int, verbose: bool, round_callback, dp,
               n_sample: int, client_states: dict, val_batch,
               injector=None, policy=None, checkpoint_dir=None,
               checkpoint_every: int = 1, resume: bool = False,
               pop=None) -> History:
    """Buffered-asynchronous rounds on a simulated heterogeneous system;
    one record per aggregation (global version bump).

      * ``n_sample`` clients are always in flight.  Each dispatch wave
        samples idle clients, trains them through the inner executor
        against the current global (tagging the uploads with its version)
        and schedules their completions at ``now + local_steps / speed``
        on the virtual clock (``core.systemsim``).
      * An aggregation takes the ``B`` earliest completions, weights them
        by data size times staleness scale
        (``server.async_aggregation_weights``), applies ``server_update``,
        bumps the version and redials ``B`` clients.  Within a buffer the
        updates aggregate in dispatch order.
      * Under the ``"fedgkd"`` scheme stale arrivals are also absorbed into
        the teacher buffer (``Algorithm.absorb_stale``).

    With faults, each dispatch draws one from the fault stream; dead and
    rejected completions are skipped by the buffer fill (which drains the
    heap until it holds ``B`` validated updates), and the failed client is
    redispatched after a capped backoff on the virtual clock, or dropped
    after ``max_retries`` consecutive failures.  Corruption is applied at
    buffer fill, never inside the heap, so a snapshot holds only finite
    uploads.

    Pipelined (``AsyncExecutor(pipelined=True)``): the inner executor
    leaves its losses on the device (``RoundContext.deferred``) and the
    refill wave is sampled, materialized, precomputed and launched before
    the round's evaluation reads anything back; the losses are read at
    aggregation.  The numbers are those of the single-stream order.

    With ``checkpoint_dir`` every aggregation's checkpoint holds the
    simulator (clock, heap with the in-flight uploads, dispatch sequence)
    and the per-client retry counts, taken after the round's refill, so a
    run killed mid-wave resumes into the same wave.

    With a population (``pop``) every dispatched client stays pinned in its
    tiers until its completion aggregates, fails, or the run ends (and a
    resumed run pins the in-flight clients it restores).  Placed over
    several hosts, each wave trains through ``_multihost_wave`` under its
    own exchange tag (``wave_seq``, carried in the checkpoints) and the
    simulator's dispatches are the same on every host, so the heaps, the
    clock and the aggregations never diverge; the losses are read per wave
    (the uploads cross the exchange at once), so nothing is deferred.
    """
    b = exec_.buffer_size if exec_.buffer_size is not None else n_sample
    if not (1 <= b <= n_sample):
        raise ValueError(
            f"async buffer_size must be in [1, cohort={n_sample}]: a larger "
            f"buffer than the in-flight fleet can never fill (got {b})")
    sim = systemsim.SystemSim(
        data.n_clients, profile=exec_.profile,
        availability=exec_.availability, rng=systemsim.derive_rng(seed),
        base_step_time=exec_.base_step_time)

    def client_work(n: int) -> int:
        """Local steps of a client of ``n`` examples: its virtual work."""
        steps = num_batches(n, ctx.batch_size, ctx.epochs)
        if ctx.max_batches is not None:
            steps = min(steps, ctx.max_batches)
        return steps

    # priced from client sizes (``client_n`` materializes nothing) and
    # memoised per sampled client: no O(population) work
    work_memo: dict[int, int] = {}

    def work_of(k: int) -> int:
        w = work_memo.get(k)
        if w is None:
            w = work_memo[k] = client_work(data.client_n(k))
        return w

    multihost = pop is not None and getattr(pop, "multihost", False)
    ctx.deferred = bool(exec_.pipelined and inner.name != "sequential"
                        and not multihost)

    in_flight: set[int] = set()
    version = 0
    stale_absorbed = 0
    max_stale = 0.0
    records: list[RoundRecord] = []
    uploads: list[dict] = []
    ftel = ctx.telemetry.get("faults")
    fail_count: dict[int, int] = {}     # consecutive failures per client
    dead_hosts: set = set()     # peers that missed an exchange deadline
    wave_seq = 0    # the waves' exchange tags, in lockstep on every host
    mh_stats: dict = {"hosts": None}    # the hosts' latest tier counters
    ckpt_host = pop.placement.host_id if multihost else None

    def owned_only(ids):
        """Under placement, the ids of this host's slice: only they are
        pinned here."""
        return [k for k in ids if pop.owned(k)] if multihost else list(ids)

    def schedule(k, upload, weight, loss, fault, delay) -> None:
        slowdown = (injector.profile.timeout_factor
                    if fault is not None and fault[0] == "timeout" else 1.0)
        in_flight.add(k)
        sim.dispatch(k, work_of(k), tag={
            "upload": upload, "weight": weight, "loss": loss,
            "version": version, "fault": fault}, delay=delay,
            slowdown=slowdown)

    def launch(cids: "list[int]", delay: float = 0.0) -> None:
        """Train ``cids`` against the current global and schedule their
        completions, each with its fault draw: a faulted dispatch still
        occupies the heap (for the timeout factor's longer duration on a
        timeout), its tag marks it dead."""
        nonlocal wave_seq
        payload = algo.round_payload(server)
        if multihost:
            tag = f"wave{wave_seq:09d}"
            wave_seq += 1
            results, mh_stats["hosts"] = _multihost_wave(
                ctx, inner, pop, server["global"], payload, client_states,
                cids, rng, tag, injector, dead_hosts, ftel)
            for k, (up, w, lv, fault) in zip(cids, results):
                schedule(k, up, w, lv, fault, delay)
            return
        if pop is not None:
            # in flight until the completion aggregates
            pop.pin(cids)
        result = inner.run_round(
            ctx, server["global"], payload,
            [client_states[k] for k in cids],
            [data.clients[k] for k in cids], rng, client_ids=cids)
        for i, k in enumerate(cids):
            fault = injector.draw() if injector is not None else None
            if fault is None:
                # a failed client's local work is lost
                client_states[k] = result.client_states[i]
            schedule(k, result.uploads[i], result.weights[i],
                     result.local_losses[i], fault, delay)

    def dispatch_wave(k_count: int) -> None:
        if k_count == 0:
            return
        # with nothing in flight this is the synchronous loop's draw
        sampled = data.sample_cohort(rng, k_count, exclude=in_flight)
        launch([int(k) for k in sampled])

    def fill_buffer() -> list:
        """Drain the heap until it yields ``b`` validated completions; dead
        and rejected ones are skipped and their clients redispatched or
        dropped.  May return fewer than ``b`` (even none) when the whole
        fleet fails out."""
        out: list = []
        while len(out) < b and sim.in_flight > 0:
            c = sim.pop()
            fault = c.tag.get("fault")
            if fault is not None and fault[0] == "corrupt":
                up = c.tag["upload"]
                c.tag["upload"] = dict(up, params=systemsim.corrupt_params(
                    up["params"], fault[1], injector.profile.huge_scale))
            if fault is None or fault[0] == "corrupt":
                ok, reason = validate_update(
                    c.tag["upload"]["params"], server["global"],
                    max_norm_mult=policy.max_norm_mult)
                if ok:
                    out.append(c)
                    fail_count.pop(c.client, None)
                    continue
                ftel["rejected_nonfinite" if reason.startswith("nonfinite")
                     else "rejected_norm"] += 1
            # a dead completion: free the slot, retry or drop the client
            in_flight.discard(c.client)
            if pop is not None:
                pop.unpin(owned_only([c.client]))
            fails = fail_count.get(c.client, 0) + 1
            fail_count[c.client] = fails
            if fails <= policy.max_retries:
                delay = policy.backoff(fails)
                ftel["redispatches"] += 1
                ftel["retries"] += 1
                ftel["backoff_wait"] += delay
                launch([c.client], delay=delay)
            else:
                ftel["dropped_clients"] += 1
                fail_count.pop(c.client, None)
        return out

    def refill() -> None:
        if injector is None:
            dispatch_wave(b)
        else:
            # dropped clients shrink the fleet below n_sample: top it up
            dispatch_wave(max(0, min(n_sample - len(in_flight),
                                     data.n_clients - len(in_flight))))

    def save_ckpt(rnd: int) -> None:
        """Checkpoint the async run state, after the round's refill: the
        heap must hold the wave the uninterrupted run carries on with."""
        if checkpoint_dir is None or (
                rnd % checkpoint_every != 0 and rnd != rounds):
            return
        _save_checkpoint(
            checkpoint_dir, rnd, algo, server, rng, injector, records,
            client_states, data.n_clients, ftel=ftel,
            extra={"sim": sim.state(), "in_flight": sorted(in_flight),
                   "version": version, "stale_absorbed": stale_absorbed,
                   "max_stale": max_stale, "wave_seq": wave_seq,
                   "fail_count": sorted(fail_count.items())},
            host=ckpt_host)

    start_round = 0
    if resume:
        hit = recovery.load_latest_state(checkpoint_dir, device=ctx.device,
                                         host=ckpt_host)
        if multihost:
            hit = _agreed_restore(pop.placement, checkpoint_dir, hit,
                                  ctx.device)
        if hit is not None:
            state, meta, start_round = hit
            server, records = _restore_run(state, meta, algo, rng, injector,
                                           ctx, client_states)
            sim.restore(state["sim"], device=ctx.device)
            in_flight = set(int(k) for k in state["in_flight"])
            version = int(state["version"])
            stale_absorbed = int(state["stale_absorbed"])
            max_stale = float(state["max_stale"])
            fail_count.update({int(k): int(v)
                               for k, v in state["fail_count"]})
            wave_seq = int(state.get("wave_seq", 0))
            if pop is not None:
                # the restored in-flight clients hold their pins as they
                # did when the checkpoint was cut
                pop.pin(owned_only(sorted(in_flight)))
        if multihost:
            _confirm_restore(pop.placement, hit, start_round,
                             {"version": version, "algo": algo.name})

    # with checkpointing on, the last round refills too: its checkpoint is
    # then the one a longer run writes there, so a finished run can be
    # extended by resuming with more rounds
    def wants_refill(t: int) -> bool:
        return t < rounds - 1 or checkpoint_dir is not None

    if start_round == 0:
        dispatch_wave(n_sample)
    for t in range(start_round, rounds):
        t0 = time.time()
        if injector is None:
            completions = sim.pop_batch(b)
        else:
            completions = fill_buffer()
            if not completions:
                # the whole fleet failed out: hold the global, record the
                # skipped event, redial
                ftel["skipped_rounds"] += 1
                acc, loss = ((records[-1].test_acc, records[-1].test_loss)
                             if records else
                             evaluate(model, server["global"], data.test_x,
                                      data.test_y))
                records.append(RoundRecord(
                    t + 1, acc, loss, 0.0, time.time() - t0,
                    sim_time=sim.now, version=version))
                if wants_refill(t):
                    dispatch_wave(min(b, data.n_clients - len(in_flight)))
                save_ckpt(t + 1)
                continue
        # the aggregation order: the dispatch sequence
        completions.sort(key=lambda c: c.seq)
        staleness = [version - c.tag["version"] for c in completions]
        max_stale = max(max_stale, float(max(staleness)))
        data_weights = [c.tag["weight"] for c in completions]
        weights = async_aggregation_weights(
            data_weights, staleness, exec_.staleness, a=exec_.staleness_a,
            cutoff=exec_.staleness_cutoff, normalize=False)
        # a deferred wave's losses are read here, once for the buffer
        local_losses = _read_losses([c.tag["loss"] for c in completions])
        if verbose and t == start_round:
            print(f"[{algo.name}] executor route: async/"
                  f"{ctx.telemetry.get('route', inner.name)} (buffer B={b}, "
                  f"staleness={exec_.staleness}, "
                  f"profile={sim.profile.kind})")

        uploads = [c.tag["upload"] for c in completions]
        server, uploads = _aggregate(algo, server, uploads, weights, model,
                                     val_batch, data.n_clients, dp, t)
        if exec_.staleness == "fedgkd":
            n_stale = sum(1 for s in staleness if s > 0)
            if n_stale:
                stale_absorbed += n_stale
                server = algo.absorb_stale(server, uploads, staleness,
                                           data_weights, model=model,
                                           val_batch=val_batch)
        version += 1
        for c in completions:
            in_flight.discard(c.client)
        if pop is not None:
            pop.unpin(owned_only([c.client for c in completions]))
            ctx.telemetry["population"] = _pop_telemetry(pop, mh_stats)

        refilled = False
        if ctx.deferred and wants_refill(t):
            # pipelined: the refill wave goes out before the evaluation
            # reads anything back (it consumes no rng, so the sampled
            # history is unchanged)
            refill()
            refilled = True
        if (t + 1) % eval_every == 0 or t == rounds - 1:
            acc, loss = evaluate(model, server["global"], data.test_x,
                                 data.test_y)
        else:
            acc, loss = ((records[-1].test_acc, records[-1].test_loss)
                         if records else (0.0, 0.0))
        if wants_refill(t) and not refilled:
            refill()
        # no synchronize here: the refill wave trains on while the next
        # aggregation starts, so ``seconds`` is the host's time
        records.append(RoundRecord(
            t + 1, acc, loss, float(np.mean(local_losses)),
            time.time() - t0, sim_time=sim.now, version=version,
            mean_staleness=float(np.mean(staleness)),
            sampled=tuple(c.client for c in completions)))
        save_ckpt(t + 1)
        if round_callback is not None:
            round_callback(t + 1, server, model)
        if verbose:
            print(f"[{algo.name}] agg {t + 1:3d}/{rounds} v{version} "
                  f"acc={acc:.4f} loss={loss:.4f} "
                  f"local={np.mean(local_losses):.4f} "
                  f"sim_t={sim.now:.1f} stale={np.mean(staleness):.2f}")

    if pop is not None and in_flight:
        # clients still in flight at the end: a reused population would
        # otherwise exempt them from eviction for good
        pop.unpin(owned_only(in_flight))
        ctx.telemetry["population"] = _pop_telemetry(pop, mh_stats)
    ctx.telemetry.update(
        route="async", inner_route=ctx.telemetry.get("route", inner.name),
        buffer_size=b, staleness_scheme=exec_.staleness,
        aggregations=rounds, final_version=version,
        stale_absorbed=stale_absorbed,
        mean_staleness=float(np.mean([r.mean_staleness for r in records])),
        max_staleness=max_stale, sim=sim.stats())
    if injector is not None:
        ftel.update(injector.counters)

    local_acc = 0.0
    if uploads:
        local_acc, _ = evaluate(model, uploads[-1]["params"], data.test_x,
                                data.test_y)
    return History(algo.name, records, server["global"], local_acc,
                   dict(ctx.telemetry))


def _pop_telemetry(pop, mh_stats: dict) -> dict:
    """The population's counters, with every host's under placement."""
    if getattr(pop, "multihost", False):
        return dict(pop.stats(), hosts=mh_stats["hosts"])
    return pop.stats()


def make_federated_data(task: PaperTask, alpha: float, seed: int = 0,
                        n_test: int = 1000) -> FederatedData:
    xtr, ytr, xte, yte = make_task_data(task, task.train_size, n_test, seed=seed)
    return FederatedData.from_arrays(xtr, ytr, xte, yte,
                                     n_clients=task.n_clients, alpha=alpha,
                                     seed=seed)
