"""Cells of a paper CV task: ``core.fl_loop.run_federated`` with FedGKD.

The harness makes the images on the card from the seed
(``frozen.data.federated_images``) and hands them in as a
``FederatedData`` of host arrays, and draws the initial weights on the
card (``frozen.layouts``), handed in through the model bundle's ``init``.
``run_federated`` draws its cohorts and batches from the seed itself and
trains through the vmap executor's client-batched body with the teacher
precompute (``executor="auto"``), evaluating every round.

Readings of the first ``compared_rounds`` rounds (the warm-up's): each
round's loss, the mean of its local steps' per-client losses, and the
clients' first gradients in each round (from the step's output), the
evaluation (from ``evaluate``), the global model's change after the last
compared round (from the round callback), and the teacher's change from
the initial weights in rounds 2 to ``teacher_rounds`` (from the payload).
Spans: ``eval`` around ``fl_loop.evaluate``, ``server`` around
``fl_loop._aggregate`` and FedGKD's ``round_payload``.  Each round's
model FLOPs follow from its cohort's shards (``sample_cohort``).
"""
from __future__ import annotations

import dataclasses

import torch

from cardbench.frozen import data as fdata
from cardbench.frozen import layouts
from cardbench.frozen import roofline as rl
from cardbench.harness import StopWindow, check_layout
from cardbench.reference import common
from cardbench.reference import resnet8 as ref

ALL_ROUNDS = 10 ** 9


@dataclasses.dataclass
class State:
    data: dict
    layout: dict
    weights: dict


def prepare(run) -> State:
    from repro_torch.models import resnet

    cfg, tr, dev = run.config, run.traffic, run.device
    layout = layouts.resnet8_layout(cfg["width"], cfg["num_classes"],
                                    cfg["channels"])
    check_layout(layout, resnet.resnet8_init(None, cfg["num_classes"],
                                              width=cfg["width"]))
    data = fdata.federated_images(
        run.seed, n_clients=cfg["n_clients"], train_size=cfg["train_size"],
        partition_seed=cfg["partition_seed"], n_test=cfg["test_size"],
        classes=cfg["num_classes"], hw=cfg["image_hw"],
        channels=cfg["channels"], alpha=cfg["alpha"], device=dev)
    run.peak_flops = rl.PEAK_BY_DTYPE[cfg["dtype"]]
    return State(data, layout, layouts.draw(layout, run.seed, dev))


def drive(run, st: State) -> None:
    from repro_torch.configs.paper import CIFAR10
    from repro_torch.core import algorithms, client, fl_loop
    from repro_torch.data.pipeline import ClientData, FederatedData

    cfg, tr = run.config, run.traffic
    task = dataclasses.replace(
        CIFAR10, num_classes=cfg["num_classes"],
        train_size=cfg["train_size"], n_clients=cfg["n_clients"],
        local_epochs=tr["local_epochs"],
        participation=tr["cohort"] / cfg["n_clients"], batch_size=tr["batch"],
        lr=cfg["lr"], momentum=cfg["momentum"],
        weight_decay=cfg["weight_decay"], gamma=tr["gamma"],
        buffer_m=tr["buffer_m"], image_hw=cfg["image_hw"])
    d = st.data
    fed = FederatedData([ClientData(x, y) for x, y in d["clients"]],
                        d["test_x"], d["test_y"], d["label_matrix"])
    algo = algorithms.FedGKD(gamma=tr["gamma"], buffer_m=tr["buffer_m"])
    handed = [st.weights]          # the port takes them; nothing keeps them
    st.weights = None
    f = rl.resnet8_forward_flops(cfg["width"], cfg["num_classes"],
                                 cfg["image_hw"])
    flops: dict = {}

    def sample_cohort(real):
        def wrapped(rng, k, exclude=None):
            cids = real(rng, k, exclude)
            sizes = [fed.client_n(c) for c in cids]
            # a round's model FLOPs: each client's train steps (forward and
            # backward on full batches), the teacher over its whole shard,
            # and the test set
            rows = sum(min(tr["batch"], n) * fdata.client_steps(
                n, tr["batch"], tr["local_epochs"],
                tr["max_batches_per_client"]) for n in sizes)
            flops[run.round] = f * (3 * rows + sum(sizes) + cfg["test_size"])
            return cids
        return wrapped
    run.round_flops = lambda t: flops[t]

    def make_model(make):
        def wrapped(*a, **kw):
            bundle = make(*a, **kw)
            return dataclasses.replace(bundle, init=lambda gen: handed.pop())
        return wrapped

    def make_step(make):
        def wrapped(loss_fn, opt):
            step = make(loss_fn, opt)

            def recorded(*a):
                out = step(*a)
                if run.round <= run.compared:
                    run.readings["loss"].append(out[3])
                    if len(run.readings["grad1"]) < run.round:
                        run.readings["grad1"].append(
                            common.leaf_norms(out[1], 1))
                return out
            return recorded
        return wrapped

    def evaluate(real):
        def wrapped(*a, **kw):
            with run.span("eval"):
                acc, loss = real(*a, **kw)
            if run.round <= run.compared:
                run.readings["eval_loss"].append(loss)
            return acc, loss
        return wrapped

    def spanned(real):
        def wrapped(*a, **kw):
            with run.span("server"):
                return real(*a, **kw)
        return wrapped

    def payload(real):
        def wrapped(server):
            with run.span("server"):
                out = real(server)
            if 2 <= run.round <= run.cell.workload["teacher_rounds"]:
                run.readings["teacher"].append(common.change_norms(
                    out["teacher"], st.layout, run.seed))
            return out
        return wrapped

    def on_round(t, server, model):
        if t == run.compared:
            run.readings["delta"] = common.change_norms(
                server["global"], st.layout, run.seed)
        run.on_round(t)

    run.patch(fed, "sample_cohort", sample_cohort)
    run.patch(fl_loop, "make_model", make_model)
    run.patch(client, "make_step", make_step)
    run.patch(fl_loop, "evaluate", evaluate)
    run.patch(fl_loop, "_aggregate", spanned)
    run.patch(algo, "round_payload", payload)
    try:
        fl_loop.run_federated(
            task, algo, fed, rounds=ALL_ROUNDS, seed=run.seed,
            eval_every=tr["eval_every"],
            max_batches_per_client=tr["max_batches_per_client"],
            width=cfg["width"], round_callback=on_round, executor="auto",
            device=run.device)
    except StopWindow:
        pass


def program_readings(run) -> dict:
    r = run.readings
    steps = r["loss"]
    per_round = len(steps) // run.compared
    # each round's loss: the mean over its clients and local steps, the
    # round's ``mean_local_loss``
    return {"loss": torch.stack([torch.stack(steps[i * per_round:
                                                   (i + 1) * per_round]).mean()
                                 for i in range(run.compared)]),
            "grad1": torch.stack(r["grad1"]), "delta": r["delta"],
            "teacher": (torch.stack(r["teacher"]) if r["teacher"]
                        else torch.zeros((0, r["delta"].shape[-1]))),
            "eval_loss": torch.tensor(r["eval_loss"], dtype=torch.float64)}


def reference(run, st: State, precision: str = "fp32", fault=None) -> dict:
    init = layouts.draw(st.layout, run.seed, run.device, torch.float32)
    return ref.readings(init, st.layout, run.seed, st.data, run.config,
                        run.traffic, run.compared,
                        run.cell.workload["teacher_rounds"], run.device,
                        precision, fault)
