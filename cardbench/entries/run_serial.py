"""Cells of a causal LM: ``launch.train.run_serial`` with FedGKD.

The port's config of the architecture (``configs.get_config``) at the
depth of the benchmark's configuration file, every other size checked
against that file.  The harness draws the initial weights on the card
(``frozen.layouts``) and hands them in through ``transformer.init``, which
``run_serial`` calls once; ``run_serial`` makes each round's token batches
from the seed itself and trains K clients one after another.

Readings of the first ``compared_rounds`` rounds: every local step's loss
and KD term and each client's first gradient in each round (from the
step's output),
the evaluation's CE (the log of ``eval_ppl``), the global model's change
after the last compared round (from the round callback), and the teacher's
change from the initial weights in rounds 2 to ``teacher_rounds`` (from
``ensemble_average``).  Spans: ``client_data`` around
``train.client_batches``, ``eval`` around ``train.eval_ppl``, ``server``
around ``train.weighted_average`` and ``train.ensemble_average``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from cardbench.frozen import layouts
from cardbench.frozen import roofline as rl
from cardbench.harness import StopWindow, check_layout
from cardbench.reference import common
from cardbench.reference import lm as ref

ALL_ROUNDS = 10 ** 9
SIZES = ("d_model", "n_layers", "n_heads", "n_kv_heads", "head_dim", "d_ff",
         "vocab_size", "rope_theta", "tie_embeddings", "norm", "act",
         "param_dtype", "activation_dtype", "remat")


@dataclasses.dataclass
class State:
    layout: dict
    model_cfg: object


def _layout(cfg: dict) -> dict:
    return layouts.dense_lm_layout(cfg["d_model"], cfg["n_layers"],
                                   cfg["n_heads"], cfg["n_kv_heads"],
                                   cfg["head_dim"], cfg["d_ff"],
                                   cfg["vocab_size"], cfg["param_dtype"])


def prepare(run) -> State:
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg, tr = run.config, run.traffic
    model_cfg = get_config(cfg["name"]).replace(n_layers=cfg["n_layers"])
    port = {k: getattr(model_cfg, k) for k in SIZES}
    mine = {k: cfg[k] for k in SIZES}
    if port != mine or model_cfg.family != "dense" or model_cfg.moe:
        raise ValueError(f"the port's {cfg['name']} is {port}, the "
                         f"benchmark's {mine}")
    layout = _layout(cfg)
    check_layout(layout, transformer.init(None, model_cfg))
    n = rl.dense_lm_params(cfg["d_model"], cfg["n_layers"], cfg["n_heads"],
                           cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"],
                           cfg["vocab_size"])
    tokens = tr["batch"] * (tr["seq"] - 1)
    per_round = (tr["clients"] * tr["batches_per_round"]
                 * rl.lm_model_flops(n, tokens, "train", with_teacher=True)
                 + rl.lm_model_flops(n, ref.fdata.LM_EVAL_BATCH
                                     * (tr["seq"] - 1), "forward"))
    run.round_flops = lambda t: per_round
    run.peak_flops = rl.PEAK_BY_DTYPE[cfg["activation_dtype"]]
    return State(layout, model_cfg)


def drive(run, st: State) -> None:
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer

    tr = run.traffic
    per_client = tr["batches_per_round"]
    counter = {"round": 0, "i": 0}

    def init(real):
        return lambda gen, c: layouts.draw(st.layout, run.seed, run.device)

    def make_train_step(make):
        def wrapped(*a, **kw):
            step = make(*a, **kw)

            def recorded(params, teacher, opt_state, batch):
                out = step(params, teacher, opt_state, batch)
                if counter["round"] != run.round:
                    counter.update(round=run.round, i=0)
                i = counter["i"]
                counter["i"] += 1
                if run.round <= run.compared:
                    run.readings["loss"].append(out[2]["loss"])
                    run.readings["kd"].append(out[2]["kd"])
                    if i % per_client == 0:
                        run.readings["grad1"].append(
                            common.leaf_norms(out[1]))
                return out
            return recorded
        return wrapped

    def spanned(name):
        def make(real):
            def wrapped(*a, **kw):
                with run.span(name):
                    return real(*a, **kw)
            return wrapped
        return make

    def eval_ppl(real):
        def wrapped(*a, **kw):
            with run.span("eval"):
                ppl = real(*a, **kw)
            if run.round <= run.compared:
                run.readings["eval_loss"].append(math.log(ppl))
            return ppl
        return wrapped

    def ensemble_average(real):
        def wrapped(*a, **kw):
            with run.span("server"):
                out = real(*a, **kw)
            if 2 <= run.round <= run.cell.workload["teacher_rounds"]:
                run.readings["teacher"].append(common.change_norms(
                    out, st.layout, run.seed))
            return out
        return wrapped

    def on_round(t, params):
        if t == run.compared:
            run.readings["delta"] = common.change_norms(params, st.layout,
                                                        run.seed)
        run.on_round(t)

    run.patch(transformer, "init", init)
    run.patch(steps, "make_train_step", make_train_step)
    run.patch(train, "client_batches", spanned("client_data"))
    run.patch(train, "eval_ppl", eval_ppl)
    run.patch(train, "weighted_average", spanned("server"))
    run.patch(train, "ensemble_average", ensemble_average)
    try:
        train.run_serial(
            st.model_cfg, rounds=ALL_ROUNDS, n_clients=tr["clients"],
            batches_per_round=per_client, batch=tr["batch"], seq=tr["seq"],
            algo=tr["algorithm"], gamma=tr["gamma"], buffer_m=tr["buffer_m"],
            lr=run.config["lr"], seed=run.seed, verbose=False, device=run.device,
            round_callback=on_round)
    except StopWindow:
        pass


def program_readings(run) -> dict:
    r, tr = run.readings, run.traffic
    shape = (run.compared, tr["clients"], tr["batches_per_round"])
    # the steps run client after client: (rounds, batches, clients)
    return {"loss": torch.stack(r["loss"]).reshape(shape).transpose(1, 2),
            "kd": torch.stack(r["kd"]).reshape(shape).transpose(1, 2),
            "grad1": torch.stack(r["grad1"]).reshape(shape[:2] + (-1,)),
            "delta": r["delta"],
            "teacher": torch.stack(r["teacher"]),
            "eval_loss": torch.tensor(r["eval_loss"], dtype=torch.float64)}


def reference(run, st: State, precision: str = "fp32", fault=None) -> dict:
    init = layouts.draw(st.layout, run.seed, run.device)
    return ref.readings(init, st.layout, run.seed, run.config, run.traffic,
                        run.compared, run.cell.workload["teacher_rounds"],
                        run.device, precision, fault)
