"""Algorithm-agnostic federated training loop (Alg. 1 ServerExecution).

The port of the synchronous path of ``repro.core.fl_loop.run_federated``:
per round, sample the cohort, build the broadcast payload, train the cohort
through the executor, aggregate, evaluate.  The numpy generator is consumed
in the reference's order and count (cohort draw, then each client's batch
picks), so one seed samples the same cohorts and batches in both packages.

Runs on ``"cuda"`` unless the caller passes ``device="cpu"``; without a card
and without that argument it raises rather than fall back.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.paper import PaperTask
from repro_torch.core import executor as executor_lib
from repro_torch.core.algorithms import Algorithm, FedGen
from repro_torch.core.distillation import accuracy, cross_entropy
from repro_torch.core.modelzoo import ModelBundle, make_model
from repro_torch.data.pipeline import FederatedData
from repro_torch.data.synthetic import make_task_data
from repro_torch.optim import adam, sgd
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class RoundRecord:
    round: int
    test_acc: float
    test_loss: float
    mean_local_loss: float
    seconds: float
    sampled: tuple = ()          # client ids aggregated this round


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
    """(accuracy, mean CE) over a test set, ``batch`` rows per forward."""
    device = tree_leaves(params)[0].device
    accs, losses, ns = [], [], []
    with torch.no_grad():
        for i in range(0, len(y), batch):
            xb = torch.from_numpy(np.ascontiguousarray(x[i:i + batch])).to(device)
            yb = torch.from_numpy(np.asarray(y[i:i + batch])).to(device)
            logits = model.apply(params, xb)
            accs.append(float(accuracy(logits, yb)) * len(yb))
            losses.append(float(cross_entropy(logits, yb)) * len(yb))
            ns.append(len(yb))
    n = sum(ns)
    return sum(accs) / n, sum(losses) / n


def run_federated(task: PaperTask, algo: Algorithm,
                  data: Optional[FederatedData] = None, *,
                  population=None, rounds: Optional[int] = None,
                  seed: int = 0, eval_every: int = 1,
                  max_batches_per_client: Optional[int] = None,
                  verbose: bool = False, width: int = 16,
                  round_callback=None, dp=None, executor="auto",
                  precompute="auto", client_batched="auto",
                  faults=None, checkpoint_dir: Optional[str] = None,
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
    unless the resolved executor is the sequential one.
    ``client_batched``: the vmap executor's client-batched round body
    (``"auto"``, ``True`` or ``False``, which forces the vmapped body; see
    ``executor.RoundContext``).  The options the port does not have yet
    raise ``NotImplementedError``: ``population=`` (ROADMAP A12),
    ``faults=`` (A10), ``checkpoint_dir=`` (A11), ``dp=`` (A14) and the
    shard_map and async executors (A13, A10).  ``device`` defaults to
    ``"cuda"``.
    """
    for arg, value, item in (("population", population, "A12"),
                             ("faults", faults, "A10"),
                             ("checkpoint_dir", checkpoint_dir, "A11"),
                             ("dp", dp, "A14")):
        if value is not None:
            raise NotImplementedError(
                f"run_federated({arg}=...) is not ported yet (ROADMAP {item})")
    if data is None:
        raise ValueError("pass data= (a FederatedData)")
    dev = resolve_device(device)
    rounds = rounds if rounds is not None else task.rounds
    model = make_model(task, projection_head=algo.needs_projection_head,
                       width=width)
    rng = np.random.default_rng(seed)
    # the init is drawn on the CPU, so one seed gives one init on any device
    init_gen = torch.Generator().manual_seed(seed + 1)
    global_params = tree_map(lambda t: t.to(dev), model.init(init_gen))
    if isinstance(algo, FedGen):
        probe_x = torch.from_numpy(data.clients[0].x[:2]).to(dev)
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
    if precompute == "auto":
        precompute = exec_.name != "sequential"
    ctx = executor_lib.RoundContext(
        algo=algo, model=model, opt=opt, lr=task.lr,
        batch_size=task.batch_size, epochs=task.local_epochs, device=dev,
        max_batches=max_batches_per_client, precompute=bool(precompute),
        client_batched=client_batched)
    client_states = {k: algo.init_client_state(k, global_params)
                     for k in range(data.n_clients)}
    # a small server-side validation split: FedGKD-VOTE's coefficients
    n_val = min(256, len(data.test_y) // 4)
    val_batch = (torch.from_numpy(np.ascontiguousarray(data.test_x[:n_val]))
                 .to(dev), torch.from_numpy(np.asarray(data.test_y[:n_val]))
                 .to(dev))

    records: list[RoundRecord] = []
    uploads: list[dict] = []
    for t in range(rounds):
        t0 = time.time()
        sampled = data.sample_cohort(rng, n_sample)
        payload = algo.round_payload(server)
        cids = [int(k) for k in sampled]
        result = exec_.run_round(
            ctx, server["global"], payload, [client_states[k] for k in cids],
            [data.clients[k] for k in cids], rng, client_ids=cids)
        uploads, weights = result.uploads, result.weights
        local_losses = result.local_losses
        for k, new_state in zip(cids, result.client_states):
            client_states[k] = new_state
        server = algo.server_update(server, uploads, weights, model,
                                    val_batch, n_clients=data.n_clients)
        if verbose and t == 0:
            print(f"[{algo.name}] executor route: "
                  f"{ctx.telemetry.get('route', exec_.name)}")

        if (t + 1) % eval_every == 0 or t == rounds - 1:
            acc, loss = evaluate(model, server["global"], data.test_x,
                                 data.test_y)
        else:
            acc, loss = ((records[-1].test_acc, records[-1].test_loss)
                         if records else (0.0, 0.0))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        records.append(RoundRecord(t + 1, acc, loss,
                                   float(np.mean(local_losses)),
                                   time.time() - t0, sampled=tuple(cids)))
        if round_callback is not None:
            round_callback(t + 1, server, model)
        if verbose:
            print(f"[{algo.name}] round {t + 1:3d}/{rounds} acc={acc:.4f} "
                  f"loss={loss:.4f} local={np.mean(local_losses):.4f}")

    # paper Fig.2-style: accuracy of the last trained LOCAL model
    local_acc, _ = evaluate(model, uploads[-1]["params"], data.test_x,
                            data.test_y)
    return History(algo.name, records, server["global"], local_acc,
                   dict(ctx.telemetry))


def make_federated_data(task: PaperTask, alpha: float, seed: int = 0,
                        n_test: int = 1000) -> FederatedData:
    xtr, ytr, xte, yte = make_task_data(task, task.train_size, n_test, seed=seed)
    return FederatedData.from_arrays(xtr, ytr, xte, yte,
                                     n_clients=task.n_clients, alpha=alpha,
                                     seed=seed)
