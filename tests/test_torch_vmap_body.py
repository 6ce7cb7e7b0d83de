"""The vmap executor's vmapped round body and the rest of the FL core,
against the reference on the CPU.

The TOY task (the MLP on Gaussian blobs, 16 clients, 8 sampled a round)
drives the reference's quickest path: ``executor="vmap"`` runs
``torch.func.vmap`` of ``client.make_local_update`` over the cohort.  2
rounds of each of the ten algorithms from the reference's init: identical
cohorts, and the final params, each round's mean local loss, test accuracy
and test loss within 1e-5 (fp32).  FedGen is the exception: the
reference's FedGen reads ``params["fc"]``, which the MLP does not have
(``KeyError``; ROADMAP §C), so the port's FedGen on TOY, fed the
reference's ``jax.random`` draws, is held against its own sequential
executor (every TOY batch is full, so both draw at the same batch size),
and the port's vmapped FedGen against the reference's on ResNet-8 with
``client_batched=False``.  ResNet-8 FedGKD with ``client_batched=False``
(B3 and B1/B2 under ``torch.func.vmap``) is held against the reference's
and against the port's client-batched route.

Beside the trajectories: the tabular data byte for byte, one client's
masked pass with padded steps, FedGKD-VOTE's cross-round part cache
(``parts_computed`` round by round), ``eval_every``, ``precompute`` and
``client_batched`` as ``run_federated`` arguments, the widened ``"auto"``
rule, the client hooks on the vmap executor, the schedules and global-norm
clipping.
"""
import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs.paper import TOY as JAX_TOY  # noqa: E402
from repro.core import algorithms as jax_algorithms  # noqa: E402
from repro.core import client as jax_client  # noqa: E402
from repro.core import executor as jax_executor  # noqa: E402
from repro.core import fl_loop as jax_fl  # noqa: E402
from repro.core.modelzoo import make_model as jax_make_model  # noqa: E402
from repro.data.synthetic import SyntheticTabularTask as JaxTabular  # noqa: E402
from repro.optim import optimizers as jax_optimizers  # noqa: E402
from repro.optim import schedules as jax_schedules  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.paper import TOY  # noqa: E402
from repro_torch.core import algorithms, client, executor, fl_loop  # noqa: E402
from repro_torch.core import modelzoo  # noqa: E402
from repro_torch.data.synthetic import SyntheticTabularTask  # noqa: E402
from repro_torch.optim import clip_by_global_norm, global_norm, sgd  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402

from test_torch_baselines_batched import (  # noqa: E402
    TOL, assert_trajectories_match, max_diff, reference_init)
from test_torch_baselines_batched import run_port as run_port_resnet8  # noqa: E402
from test_torch_baselines_batched import \
    run_reference as run_reference_resnet8  # noqa: E402
from test_torch_baselines_stateful import (  # noqa: E402
    SEED, reference_client_noise, reference_fedgen, reference_server_noise)
from torch_threads import one_torch_thread  # noqa: E402,F401

ROUNDS = 2
# 8 local steps at most: the four smallest clients have 6 and are padded to
# the cohort's 8, and every round keeps one shape (one reference compile)
MAX_BATCHES = 8


TOY_KW = dict(rounds=ROUNDS, seed=SEED, executor="vmap",
              max_batches_per_client=MAX_BATCHES)


@functools.lru_cache(maxsize=None)
def toy_data():
    """(reference data, port data): the TOY task's, 400 test rows."""
    return (jax_fl.make_federated_data(JAX_TOY, alpha=1.0, seed=0, n_test=400),
            fl_loop.make_federated_data(TOY, alpha=1.0, seed=0, n_test=400))


@functools.lru_cache(maxsize=None)
def toy_init():
    """The reference's MLP init at ``run_federated``'s key, as numpy."""
    return jax.tree_util.tree_map(np.asarray, jax_make_model(JAX_TOY).init(
        jax.random.PRNGKey(SEED + 1)))


def run_port(monkeypatch, algo, **kw):
    real = modelzoo.make_model

    def with_reference_init(*args, **kwargs):
        return dataclasses.replace(
            real(*args, **kwargs),
            init=lambda gen: bridge.params_from_numpy(toy_init()))

    monkeypatch.setattr(fl_loop, "make_model", with_reference_init)
    return fl_loop.run_federated(TOY, algo, toy_data()[1], device="cpu",
                                 **dict(TOY_KW, **kw))


def run_reference(jalgo, **kw):
    return jax_fl.run_federated(JAX_TOY, jalgo, toy_data()[0],
                                **dict(TOY_KW, **kw))


def test_tabular_data_is_byte_identical():
    for seed in (0, 3):
        a = SyntheticTabularTask(10, dim=16, seed=seed).generate(50, seed=7)
        b = JaxTabular(10, dim=16, seed=seed).generate(50, seed=7)
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()
    jdata, data = toy_data()
    assert data.test_x.tobytes() == jdata.test_x.tobytes()
    for c, jc in zip(data.clients, jdata.clients, strict=True):
        assert c.x.tobytes() == jc.x.tobytes()
        assert c.y.tobytes() == jc.y.tobytes()


# ------------------------------------------------- one client's masked pass

def _client_batches(n_steps, n_live, seed=0):
    data = toy_data()[1].clients[0]
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, data.n, size=(n_steps, 8))
    ex_mask = np.ones((n_steps, 8), np.float32)
    ex_mask[0, 5:] = 0.0
    step_mask = np.arange(n_steps) < n_live
    return data.x[pick], data.y[pick], ex_mask, step_mask


def test_local_update_with_padded_steps_matches_reference():
    """4 steps of which the last 2 are padding: the reference's scan and
    the port's loop agree, and the padded steps leave the params
    bit-identical to a 2-step pass."""
    init = toy_init()
    xs, ys, ex_mask, step_mask = _client_batches(4, 2)
    jalgo, algo = jax_algorithms.make("fedprox"), algorithms.make("fedprox")
    jmodel = jax_make_model(JAX_TOY)
    model = modelzoo.make_model(TOY)
    opt = sgd(momentum=0.9, weight_decay=1e-5)
    jopt = jax_optimizers.sgd(momentum=0.9, weight_decay=1e-5)
    payload = {"anchor": bridge.params_from_numpy(init)}
    jparams, jloss = jax.jit(jax_client.make_local_update(
        jalgo.loss_fn(jmodel), jopt))(
            init, {"anchor": init}, (), xs, ys, ex_mask, (), step_mask, 0.05)
    update = client.make_local_update(algo.loss_fn(model), opt)
    t = [torch.from_numpy(a) for a in (xs, ys, ex_mask, step_mask)]
    params, loss = update(bridge.params_from_numpy(init), payload, (), t[0],
                          t[1], t[2], (), t[3], 0.05)
    assert max_diff(bridge.params_to_numpy(params), jparams) < TOL
    assert abs(float(loss) - float(jloss)) < TOL
    short, short_loss = update(bridge.params_from_numpy(init), payload, (),
                               *(a[:2] for a in t[:3]), (), t[3][:2], 0.05)
    for a, b in zip(bridge.params_to_numpy(params).values(),
                    bridge.params_to_numpy(short).values()):
        for u, v in zip(a.values(), b.values()):
            assert u.tobytes() == v.tobytes()
    assert float(loss) == float(short_loss)


def test_local_update_composes_with_vmap():
    """``torch.func.vmap`` over 3 clients equals each client alone."""
    init = bridge.params_from_numpy(toy_init())
    algo, model = algorithms.make("fedgkd"), modelzoo.make_model(TOY)
    update = client.make_local_update(algo.loss_fn(model), sgd(momentum=0.9))
    batches = [_client_batches(3, n, seed=n) for n in (3, 1, 2)]
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*batches)]
    payload = {"teacher": init}
    both, losses = torch.func.vmap(
        update, in_dims=(None, None, 0, 0, 0, 0, 0, 0, None))(
            init, payload, (), *stacked[:3], (), stacked[3], 0.05)
    for i, b in enumerate(batches):
        one, loss = update(init, payload, (),
                           *(torch.from_numpy(a) for a in b[:3]), (),
                           torch.from_numpy(b[3]), 0.05)
        torch.testing.assert_close(losses[i], loss, rtol=0, atol=1e-6)
        for u, v in zip(bridge.params_to_numpy(one).values(),
                        bridge.params_to_numpy(both).values()):
            for a, c in zip(u.values(), v.values()):
                np.testing.assert_allclose(a, c[i], rtol=0, atol=1e-6)


# ------------------------------------------------------- 2-round trajectories

NINE = ["fedavg", "fedprox", "fedgkd", "fedgkd-vote", "fedgkd+", "moon",
        "feddistill+", "scaffold", "feddyn"]


@pytest.mark.parametrize("name", NINE)
def test_toy_vmap_trajectory_matches_reference(monkeypatch, name):
    hj = run_reference(jax_algorithms.make(name))
    ht = run_port(monkeypatch, algorithms.make(name))
    assert ht.telemetry["route"] == hj.telemetry["route"] == "vmap"
    assert ht.telemetry["round_body"] == hj.telemetry["round_body"] == "vmap"
    assert_trajectories_match(ht, hj)


@functools.lru_cache(maxsize=None)
def _reference_draws(c, nd):
    """The reference's client and server noise, each draw made once and
    kept: the runs compared here draw the same ones."""
    client_noise = reference_client_noise(SEED, nd)
    server_noise = functools.lru_cache(maxsize=None)(
        reference_server_noise(c, nd))
    seen = {}

    def cached_client_noise(payload, labels, b):
        key = (payload["round"], int(labels.sum()), b,
               payload["label_dist"].numpy().tobytes())
        if key not in seen:
            seen[key] = client_noise(payload, labels, b)
        return seen[key]

    return cached_client_noise, server_noise


def _fedgen_with_reference_draws(c, feat_dim):
    jalgo = jax_algorithms.make("fedgen")
    client_noise, server_noise = _reference_draws(c, jalgo.gcfg.noise_dim)
    algo = algorithms.make("fedgen", client_noise=client_noise,
                           server_noise=server_noise)
    gen = reference_fedgen(jalgo, c, feat_dim)
    algo._gen_init = lambda *a: bridge.params_from_numpy(gen)
    return jalgo, algo


def test_toy_fedgen_vmap_matches_sequential_with_reference_draws(monkeypatch):
    jalgo, _ = _fedgen_with_reference_draws(10, 64)
    with pytest.raises(KeyError, match="fc"):          # ROADMAP §C
        run_reference(jalgo, rounds=1)
    assert min(c.n for c in toy_data()[1].clients) >= TOY.batch_size
    hv = run_port(monkeypatch, _fedgen_with_reference_draws(10, 64)[1])
    hs = run_port(monkeypatch, _fedgen_with_reference_draws(10, 64)[1],
                  executor="sequential")
    assert (hv.telemetry["round_body"], hs.telemetry["route"]) == (
        "vmap", "sequential")
    assert_trajectories_match(hv, hs)


@pytest.mark.parametrize("name", ["fedgkd", "fedgen"])
def test_resnet8_vmapped_body_matches_reference(monkeypatch, name):
    """``client_batched=False`` on ResNet-8: the conv's and the KD term's
    vmap rules in the round body, against the reference's vmapped body."""
    jalgo = jax_algorithms.make(name)
    algo = algorithms.make(name)
    if name == "fedgen":
        jalgo, algo = _fedgen_with_reference_draws(10, 32)
    hj = run_reference_resnet8(jalgo, executor="vmap", client_batched=False)
    ht = run_port_resnet8(monkeypatch, algo, reference_init(False),
                          executor="vmap", client_batched=False)
    assert ht.telemetry["round_body"] == hj.telemetry["round_body"] == "vmap"
    assert_trajectories_match(ht, hj)
    if name == "fedgkd":
        hb = run_port_resnet8(monkeypatch, algorithms.make(name),
                              reference_init(False), executor="vmap")
        assert hb.telemetry["round_body"] == "client_batched"
        assert_trajectories_match(ht, hb)


# ----------------------------------------------------- cache, loop options

class _Recording:
    """Wraps an executor: the ``parts_computed`` count after each round."""

    def __init__(self, inner):
        self.inner, self.name, self.counts = inner, inner.name, []

    def run_round(self, ctx, *args, **kw):
        out = self.inner.run_round(ctx, *args, **kw)
        self.counts.append(ctx.telemetry.get("parts_computed", 0))
        return out


def test_fedgkd_vote_part_cache_counts_match_reference(monkeypatch):
    jexec = _Recording(jax_executor.VmapExecutor())
    texec = _Recording(executor.VmapExecutor())
    hj = run_reference(jax_algorithms.make("fedgkd-vote", buffer_m=3),
                       rounds=3, executor=jexec)
    ht = run_port(monkeypatch, algorithms.make("fedgkd-vote", buffer_m=3),
                  rounds=3, executor=texec)
    assert texec.counts == jexec.counts
    # round 1 computes one part; later rounds only the new version, plus
    # the versions new to clients that join the cohort
    assert texec.counts[0] == 1 and texec.counts[-1] < 3 * 3
    assert_trajectories_match(ht, hj)


def test_eval_every_precompute_and_client_batched_follow_reference(
        monkeypatch):
    kw = dict(rounds=3, eval_every=2, precompute=False)
    hj = run_reference(jax_algorithms.make("fedgkd"), **kw)
    ht = run_port(monkeypatch, algorithms.make("fedgkd"), **kw)
    assert [r.round for r in ht.records] == [1, 2, 3]
    assert ht.records[0].test_acc == ht.records[0].test_loss == 0.0
    assert_trajectories_match(ht, hj)
    for kw in (dict(client_batched=True), dict(client_batched=True,
                                               executor="sequential")):
        with pytest.raises(ValueError, match="client_batched=True"):
            run_reference(jax_algorithms.make("fedgkd"), **kw)
        with pytest.raises(ValueError, match="client_batched=True"):
            run_port(monkeypatch, algorithms.make("fedgkd"), **kw)


def test_precompute_auto_follows_the_resolved_executor():
    algo, model = algorithms.make("fedgkd"), modelzoo.make_model(TOY)
    seen = {}
    for spec in ("sequential", "vmap"):
        exec_ = executor.get_executor(spec, algo, 8, model)
        ctx = executor.RoundContext(
            algo=algo, model=model, opt=sgd(), lr=0.1, batch_size=8,
            epochs=1, device=torch.device("cpu"),
            precompute=exec_.name != "sequential")
        seen[spec] = ctx.has_precompute
    assert seen == {"sequential": False, "vmap": True}


@pytest.mark.parametrize("n_sample", [1, 4])
def test_auto_rule_matches_reference_on_the_mlp(n_sample):
    routes = set()
    for name in algorithms.available():
        algo, jalgo = algorithms.make(name), jax_algorithms.make(name)
        got = executor.get_executor("auto", algo, n_sample,
                                    modelzoo.make_model(TOY)).name
        assert got == jax_executor.get_executor(
            "auto", jalgo, n_sample, jax_make_model(JAX_TOY)).name
        routes.add(got)
    assert routes == {"vmap" if n_sample > 1 else "sequential"}
    assert executor.get_executor("auto", algorithms.make("moon"), 4,
                                 None).name == "vmap"


# ------------------------------------------------------ schedules, clipping

def test_schedules_match_reference():
    steps = [0, 1, 5, 9, 10, 11, 40, 100]
    pairs = [(schedules.constant(0.1), jax_schedules.constant(0.1)),
             (schedules.cosine_decay(0.1, 40), jax_schedules.cosine_decay(0.1, 40)),
             (schedules.warmup_cosine(0.1, 10, 40, 0.05),
              jax_schedules.warmup_cosine(0.1, 10, 40, 0.05))]
    for ours, ref in pairs:
        for s in steps:
            np.testing.assert_allclose(float(ours(s)), float(ref(s)),
                                       rtol=1e-6, atol=1e-9)
            assert float(ours(torch.tensor(s))) == float(ours(s))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    t = bridge.params_from_numpy(tree)
    np.testing.assert_allclose(float(global_norm(t)),
                               float(jax_optimizers.global_norm(tree)),
                               rtol=1e-6)
    want = jax_optimizers.clip_by_global_norm(tree, max_norm)
    assert max_diff(bridge.params_to_numpy(clip_by_global_norm(t, max_norm)),
                    want) < 1e-6
