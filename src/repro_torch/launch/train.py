"""End-to-end federated LM training: the serial trainer.

The port of ``repro.launch.train``'s serial path.  It trains an
architecture of the registry (reduced or full) as a causal LM with FedGKD
or FedAvg across K clients, each holding a non-IID synthetic token stream
(its own Markov source), one client at a time.  The numpy generators are
seeded and drawn in the reference's order, so one seed gives the same
tokens in both packages.

Runs on ``"cuda"`` unless the caller passes ``device="cpu"`` (``--device
cpu``); without a card and without that it raises rather than fall back.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
        --smoke --rounds 2 --clients 2 --device cpu

``--straggler-frac`` simulates a straggler tail (``make_round_clock``):
each round reports ``sim_seconds``, the virtual time the round's barrier
waits for its slowest client; it adds no device work.

``--fl-task`` runs a paper task (``cifar10``, ``cifar100``,
``tiny-imagenet``, ``toy``) through ``core.fl_loop.run_federated`` instead
(``run_fl_task``), under ``--executor``.

Not ported yet: ``--sharded`` (ROADMAP A13b), full configs in bf16
(A15.3).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

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
    round_clock = make_round_clock(n_clients, straggler_frac=straggler_frac,
                                   straggler_slowdown=straggler_slowdown,
                                   seed=seed)
    opt = sgd(momentum=0.9)
    kd_mode = "teacher" if algo == "fedgkd" else "none"
    step = steps_lib.make_train_step(cfg, opt, kd_mode=kd_mode, gamma=gamma,
                                     lr=lr)
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
        teacher = ensemble_average(buf.models) if kd_mode == "teacher" else ()
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
        del teacher, o
        global_params = weighted_average(new_params, weights)
        del new_params, p
        buf.push(global_params)
        ppl = eval_ppl(global_params, cfg, eval_toks)
        # the round's reads of the last step's loss and, under FedGKD, of
        # its KD term (0.5 * gamma * mean KL)
        rec = {"round": t + 1, "ppl": ppl, "loss": float(metrics["loss"])}
        if kd_mode == "teacher":
            rec["kd"] = float(metrics["kd"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec["seconds"] = time.perf_counter() - t0
        if round_clock is not None:
            rec["sim_seconds"] = round_clock(batches_per_round)
        history.append(rec)
        if verbose:
            print(f"[{algo}] round {t + 1}/{rounds} ppl={ppl:.2f} "
                  f"loss={rec['loss']:.4f} ({rec['seconds']:.1f}s)", flush=True)
        if round_callback is not None:
            round_callback(t + 1, global_params)
    return {"history": history, "params": global_params}


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
                    help="clients in parallel, one per device (not ported: "
                         "ROADMAP A13b)")
    ap.add_argument("--straggler-frac", type=float, default=0.0,
                    help="simulate a straggler tail: this fraction of "
                         "clients runs --straggler-slowdown x slower and "
                         "each round reports sim_seconds (the synchronous "
                         "barrier's virtual cost)")
    ap.add_argument("--straggler-slowdown", type=float, default=4.0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card, 'cpu' to run "
                         "on the CPU")
    args = ap.parse_args(argv)

    if args.fl_task:
        return run_fl_task(args)
    if args.sharded:
        raise NotImplementedError(
            "--sharded (make_parallel_round / run_sharded: one LM client per "
            "device) is not ported yet (ROADMAP A13b)")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.param_dtype != "float32" or cfg.activation_dtype != "float32":
        raise NotImplementedError(
            f"{cfg.name} is published in {cfg.param_dtype}; the port runs "
            f"float32 only (ROADMAP A15.3): pass --smoke, or call run_serial "
            f"with cfg.replace(param_dtype='float32', "
            f"activation_dtype='float32')")
    out = run_serial(cfg, n_clients=args.clients, rounds=args.rounds,
                     batches_per_round=args.batches_per_round,
                     batch=args.batch, seq=args.seq, gamma=args.gamma,
                     buffer_m=args.buffer_m, lr=args.lr, algo=args.algo,
                     device=args.device, straggler_frac=args.straggler_frac,
                     straggler_slowdown=args.straggler_slowdown)
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
