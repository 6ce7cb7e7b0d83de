"""End-to-end federated LM training: the serial and the sharded trainer.

The port of ``repro.launch.train``.  It trains an architecture of the
registry (reduced or full, in the config's dtypes: the published configs
are bf16) as a causal LM with FedGKD or FedAvg across K clients, each
holding a non-IID synthetic token stream (its own Markov source).  Two
routes, as in the reference:

  serial    ``run_serial``: K clients one at a time on one device;
  sharded   ``run_sharded``: one client per device of a device list, the
            round aggregated by ``steps.make_aggregate_step``.  The
            reference runs the clients as one ``shard_map`` program and
            aggregates with one ``psum``; here the clients run one after
            another, each on its own device (a list may repeat a device,
            so one card runs N clients), and their params are gathered to
            the first device for the weighted mean.

The numpy generators are seeded and drawn in the reference's order, so one
seed gives the same tokens in both packages.

Runs on ``"cuda"`` unless the caller passes ``device="cpu"`` (``--device
cpu``); without a card and without that it raises rather than fall back.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
        --smoke --rounds 2 --clients 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --smoke --sharded --device cpu --rounds 1 --batches-per-round 1

``--straggler-frac`` simulates a straggler tail (``make_round_clock``):
each round reports ``sim_seconds``, the virtual time the round's barrier
waits for its slowest client; it adds no device work.

``--fl-task`` runs a paper task (``cifar10``, ``cifar100``,
``tiny-imagenet``, ``toy``) through ``core.fl_loop.run_federated`` instead
(``run_fl_task``), under ``--executor``.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import systemsim
from repro_torch.core.distillation import ensemble_average
from repro_torch.core.fl_loop import resolve_device
from repro_torch.core.server import ModelBuffer, weighted_average
from repro_torch.data.synthetic import lm_token_batches
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer
from repro_torch.optim import sgd
from repro_torch.tree import tree_map

Devices = Sequence[Union[str, torch.device]]
EVAL_SEED, EVAL_BATCH = 9999, 8


def client_batches(cfg, n_clients: int, batches_per_round: int, batch: int,
                   seq: int, seed: int = 0) -> np.ndarray:
    """(K, batches_per_round, batch, seq) int32: client k draws from its own
    Markov source (the label-distribution skew of LM data)."""
    out = np.empty((n_clients, batches_per_round, batch, seq), np.int32)
    for k in range(n_clients):
        rng = np.random.default_rng(seed * 1000 + k)
        for b in range(batches_per_round):
            out[k, b] = lm_token_batches(rng, batch, seq, cfg.vocab_size)
    return out


def eval_ppl(params, cfg, tokens: torch.Tensor) -> float:
    """Perplexity of next-token prediction on ``tokens`` (B, S).  The
    exponential is taken in float64: from a random init at full width the
    CE exceeds fp32's ~88.7 (the reference's ``jnp.exp`` gives inf there)."""
    with torch.no_grad():
        logits, _ = transformer.forward(params, cfg, tokens[:, :-1])
        ce = steps_lib.lm_cross_entropy(logits, tokens[:, 1:])
        return float(torch.exp(ce.to(torch.float64)))


def make_round_clock(n_clients: int, *, straggler_frac: float,
                     straggler_slowdown: float, seed: int):
    """``None`` (no simulation), or a function of a round's work (batches
    per client) to the synchronous barrier's cost: the virtual seconds
    until the round's slowest client finishes, with speeds of the
    straggler profile drawn from the seed's simulation stream
    (``core.systemsim``)."""
    if straggler_frac <= 0.0:
        return None
    sim = systemsim.SystemSim(
        n_clients,
        systemsim.SpeedProfile(kind="straggler",
                               straggler_frac=straggler_frac,
                               straggler_slowdown=straggler_slowdown),
        rng=systemsim.derive_rng(seed))
    return lambda work: max(sim.duration(k, work) for k in range(n_clients))


def _run_rounds(cfg, train_round, *, dev, sync, label: str, rounds: int,
                n_clients: int, batches_per_round: int, batch: int, seq: int,
                algo: str, buffer_m: int, seed: int, verbose: bool,
                round_callback: Optional[Callable], straggler_frac: float,
                straggler_slowdown: float) -> dict:
    """The rounds both routes share: the init on ``dev``, the FedGKD
    buffer, each round's client batches and teacher, the evaluation, the
    round's clock and record.  ``train_round(global_params, teacher,
    data)`` -> (the new global params on ``dev``, the round's metrics as
    tensors); ``sync`` the devices whose work a round's seconds wait
    for."""
    round_clock = make_round_clock(n_clients, straggler_frac=straggler_frac,
                                   straggler_slowdown=straggler_slowdown,
                                   seed=seed)
    global_params = tree_map(lambda t: t.to(dev), transformer.init(
        torch.Generator().manual_seed(seed), cfg))
    buf = ModelBuffer(buffer_m)
    buf.push(global_params)
    eval_toks = torch.from_numpy(lm_token_batches(
        np.random.default_rng(EVAL_SEED), EVAL_BATCH, seq,
        cfg.vocab_size)).to(dev)
    history = []
    for t in range(rounds):
        t0 = time.perf_counter()
        data = torch.from_numpy(client_batches(
            cfg, n_clients, batches_per_round, batch, seq, seed=seed + t))
        teacher = ensemble_average(buf.models) if algo == "fedgkd" else ()
        global_params, metrics = train_round(global_params, teacher, data)
        del teacher
        buf.push(global_params)
        ppl = eval_ppl(global_params, cfg, eval_toks)
        rec = {"round": t + 1, "ppl": ppl,
               **{k: float(v) for k, v in metrics.items()}}
        for d in sync:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        rec["seconds"] = time.perf_counter() - t0
        if round_clock is not None:
            rec["sim_seconds"] = round_clock(batches_per_round)
        history.append(rec)
        if verbose:
            print(f"[{label}] round {t + 1}/{rounds} ppl={ppl:.2f} "
                  f"loss={rec['loss']:.4f} ({rec['seconds']:.1f}s)", flush=True)
        if round_callback is not None:
            round_callback(t + 1, global_params)
    return {"history": history, "params": global_params}


def run_serial(cfg, *, rounds: int, n_clients: int, batches_per_round: int,
               batch: int, seq: int, algo: str = "fedgkd", gamma: float = 0.2,
               buffer_m: int = 3, lr: float = 0.1, seed: int = 0,
               verbose: bool = True, device=None,
               round_callback: Optional[Callable] = None,
               straggler_frac: float = 0.0,
               straggler_slowdown: float = 4.0) -> dict:
    """``rounds`` rounds of ``algo`` ("fedgkd" or "fedavg"), every client
    training ``batches_per_round`` steps of SGD (momentum 0.9) from the
    global model; returns ``{"history": [per-round dicts], "params"}``,
    each dict holding the round's ``ppl``, its last step's ``loss`` (and
    ``kd`` under FedGKD), its ``seconds`` and, with ``straggler_frac > 0``,
    its ``sim_seconds`` (``make_round_clock``).
    ``round_callback(round, params)`` runs after each round's evaluation,
    once the device has finished it."""
    dev = resolve_device(device)
    opt = sgd(momentum=0.9)
    kd_mode = "teacher" if algo == "fedgkd" else "none"
    step = steps_lib.make_train_step(cfg, opt, kd_mode=kd_mode, gamma=gamma,
                                     lr=lr)

    def train_round(global_params, teacher, data):
        new_params, weights = [], []
        for k in range(n_clients):
            p = global_params
            o = opt.init(p)
            for b in range(batches_per_round):
                bt = data[k, b].to(dev)
                p, o, metrics = step(p, teacher, o,
                                     {"tokens": bt[:, :-1], "labels": bt[:, 1:]})
            new_params.append(p)
            weights.append(float(batch * batches_per_round))
        # the round's reads of the last step's loss and, under FedGKD, of
        # its KD term (0.5 * gamma * mean KL)
        read = {"loss": metrics["loss"]}
        if kd_mode == "teacher":
            read["kd"] = metrics["kd"]
        return weighted_average(new_params, weights), read

    return _run_rounds(
        cfg, train_round, dev=dev, sync=[dev], label=algo, rounds=rounds,
        n_clients=n_clients, batches_per_round=batches_per_round, batch=batch,
        seq=seq, algo=algo, buffer_m=buffer_m, seed=seed, verbose=verbose,
        round_callback=round_callback, straggler_frac=straggler_frac,
        straggler_slowdown=straggler_slowdown)


def make_parallel_round(cfg, devices: Devices, *, gamma: float = 0.2,
                        lr: float = 0.1, kd_mode: str = "teacher"):
    """The round of ``run_sharded``: round_fn(global_params, teacher,
    tokens, weights) -> (the weighted mean of the clients' params on the
    first device, the mean over clients of each client's mean step loss).

    Client k runs on ``devices[k]`` from the global params, with a fresh
    SGD state (momentum 0.9), through its batches ``tokens[k]``
    (batches_per_round, batch, seq) in order, as the reference's
    ``per_client``; its params stay on its device until the aggregation
    (``steps.make_aggregate_step``) gathers them.  The clients run one
    after another."""
    devices = [torch.device(d) for d in devices]
    opt = sgd(momentum=0.9)
    step = steps_lib.make_train_step(cfg, opt, kd_mode=kd_mode, gamma=gamma,
                                     lr=lr)
    aggregate = steps_lib.make_aggregate_step()

    def per_client(params, teacher, tokens, dev):
        opt_state = opt.init(params)
        losses = []
        for bt in tokens.to(dev):
            params, opt_state, m = step(params, teacher, opt_state,
                                        {"tokens": bt[:, :-1],
                                         "labels": bt[:, 1:]})
            losses.append(m["loss"])
        return params, torch.stack(losses).mean()

    def round_fn(global_params, teacher, tokens, weights):
        if len(tokens) != len(devices):
            raise ValueError(f"{len(tokens)} clients' batches for "
                             f"{len(devices)} devices")
        new_params, losses = [], []
        for k, dev in enumerate(devices):
            to_dev = lambda tree: tree_map(lambda t: t.to(dev), tree)
            p, loss = per_client(to_dev(global_params),
                                 to_dev(teacher) if kd_mode == "teacher"
                                 else (), tokens[k], dev)
            new_params.append(p)
            losses.append(loss.to(devices[0]))
        return aggregate(new_params, weights), torch.stack(losses).mean()

    return round_fn


def sharded_devices(devices: Optional[Devices] = None) -> list[torch.device]:
    """The clients' devices: ``devices`` as given (a device may repeat), or
    every CUDA card of the host; raises without a card unless the list
    names the CPU, as ``resolve_device`` does."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("run_sharded needs at least one device")
    return devices


def run_sharded(cfg, *, rounds: int, batches_per_round: int, batch: int,
                seq: int, gamma: float = 0.2, buffer_m: int = 3,
                lr: float = 0.1, seed: int = 0, algo: str = "fedgkd",
                verbose: bool = True, devices: Optional[Devices] = None,
                straggler_frac: float = 0.0,
                straggler_slowdown: float = 4.0) -> dict:
    """``rounds`` rounds with one client per device of ``devices``
    (``sharded_devices``), equal weights, every client training
    ``batches_per_round`` steps from the global model
    (``make_parallel_round``); returns what ``run_serial`` returns, each
    round's ``loss`` the mean over clients of each client's mean step loss
    (the reference's ``pmean``).  The global model, the FedGKD buffer and
    the evaluation live on the first device."""
    devices = sharded_devices(devices)
    round_fn = make_parallel_round(
        cfg, devices, gamma=gamma, lr=lr,
        kd_mode="teacher" if algo == "fedgkd" else "none")
    weights = torch.ones((len(devices),), dtype=torch.float32)

    def train_round(global_params, teacher, data):
        global_params, loss = round_fn(global_params, teacher, data, weights)
        return global_params, {"loss": loss}

    return _run_rounds(
        cfg, train_round, dev=devices[0], sync=set(devices),
        label=f"{algo}/sharded", rounds=rounds, n_clients=len(devices),
        batches_per_round=batches_per_round, batch=batch, seq=seq,
        algo=algo, buffer_m=buffer_m, seed=seed, verbose=verbose,
        round_callback=None, straggler_frac=straggler_frac,
        straggler_slowdown=straggler_slowdown)


def run_fl_task(args) -> int:
    """The single-host FL-loop preset path: ``--fl-task cifar10`` etc.

    Drives ``fl_loop.run_federated`` on a paper task (ResNet-8 for the
    CIFAR tasks, ResNet-50 for Tiny-ImageNet, the MLP for TOY) under
    ``--executor``, with the reference's data (α 10, 256 test examples,
    seed 0), and prints the round body that ran, from the telemetry."""
    import dataclasses

    from repro_torch.configs.paper import PAPER_TASKS, scaled
    from repro_torch.core import algorithms as algo_lib
    from repro_torch.core import fl_loop

    task = scaled(PAPER_TASKS[args.fl_task], scale=args.fl_scale,
                  rounds=args.rounds, local_epochs=1)
    if args.clients:
        task = dataclasses.replace(
            task, n_clients=max(task.n_clients, args.clients),
            participation=args.clients / max(task.n_clients, args.clients))
    data = fl_loop.make_federated_data(task, alpha=10.0, seed=0, n_test=256)
    h = fl_loop.run_federated(
        task, algo_lib.make(args.algo, gamma=args.gamma,
                            buffer_m=args.buffer_m),
        data, seed=0, width=args.fl_width, executor=args.executor,
        max_batches_per_client=args.batches_per_round, verbose=True,
        device=args.device)
    print(f"model={task.model} executor={args.executor} "
          f"round_body={h.telemetry.get('round_body', '-')} "
          f"final_acc={h.final_acc:.4f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--fl-task", default=None, choices=sorted(
                        ("cifar10", "cifar100", "tiny-imagenet", "toy")),
                    help="run the single-host FL loop on a paper task "
                         "(model=resnet8/resnet50/mlp per task) instead of "
                         "the LM trainer; --executor selects the route")
    ap.add_argument("--executor", default="auto",
                    help="FL-task executor: auto/sequential/vmap/shard_map/"
                         "async (vmap on the conv backbones uses the "
                         "client-batched grouped-conv body)")
    ap.add_argument("--fl-scale", type=float, default=0.02,
                    help="FL-task dataset scale (CPU-sized default)")
    ap.add_argument("--fl-width", type=int, default=16,
                    help="resnet8 width for --fl-task")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--algo", choices=("fedavg", "fedgkd"), default="fedgkd")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batches-per-round", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--gamma", type=float, default=0.2)
    ap.add_argument("--buffer-m", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--sharded", action="store_true",
                    help="one client per device (every CUDA card; one CPU "
                         "client under --device cpu), aggregated on the "
                         "first")
    ap.add_argument("--straggler-frac", type=float, default=0.0,
                    help="simulate a straggler tail: this fraction of "
                         "clients runs --straggler-slowdown x slower and "
                         "each round reports sim_seconds (the synchronous "
                         "barrier's virtual cost)")
    ap.add_argument("--straggler-slowdown", type=float, default=4.0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (every card "
                         "under --sharded), 'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    if args.fl_task:
        return run_fl_task(args)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    kw = dict(rounds=args.rounds, batches_per_round=args.batches_per_round,
              batch=args.batch, seq=args.seq, gamma=args.gamma,
              buffer_m=args.buffer_m, lr=args.lr, algo=args.algo,
              straggler_frac=args.straggler_frac,
              straggler_slowdown=args.straggler_slowdown)
    if args.sharded:
        out = run_sharded(cfg, devices=(None if args.device is None
                                        else [args.device]), **kw)
    else:
        out = run_serial(cfg, n_clients=args.clients, device=args.device,
                         **kw)
    print("final ppl:", out["history"][-1]["ppl"])
    if args.straggler_frac > 0:
        total = sum(r["sim_seconds"] for r in out["history"])
        print(f"simulated round-barrier time: {total!r} virtual s over "
              f"{args.rounds} rounds (straggler tail "
              f"{args.straggler_frac:.0%} at "
              f"{args.straggler_slowdown:g}x slowdown)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
