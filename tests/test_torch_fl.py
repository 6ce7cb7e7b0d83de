"""The port's slice end to end against the JAX reference, on the CPU.

FedAvg and FedGKD on ResNet-8, 2 rounds over 6 ragged clients (the
reference's ``resnet_setup`` fixture: 16x16 images, width 8, batch 8,
lr 0.01).  Both packages start from the reference's initialisation (the
port's is replaced through the bridge) and draw cohorts and batches from
the same numpy seed: the cohorts must be identical, and the final params,
local losses and test accuracy within 1e-5 (fp32, different summation
orders).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs.paper import CIFAR10 as JAX_CIFAR10  # noqa: E402
from repro.core import algorithms as jax_algorithms  # noqa: E402
from repro.core import fl_loop as jax_fl  # noqa: E402
from repro.core.modelzoo import make_model as jax_make_model  # noqa: E402
from repro.data.pipeline import ClientData as JaxClientData  # noqa: E402
from repro.data.pipeline import FederatedData as JaxFederatedData  # noqa: E402
from repro.data.synthetic import SyntheticImageTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.paper import CIFAR10  # noqa: E402
from repro_torch.core import algorithms, fl_loop  # noqa: E402
from repro_torch.core import modelzoo  # noqa: E402
from repro_torch.data.pipeline import ClientData, FederatedData  # noqa: E402

SIZES = (5, 9, 12, 20, 8, 16)       # ragged, as tests/test_executor.py
FIXTURE = dict(n_clients=len(SIZES), participation=1.0, batch_size=8,
               rounds=2, local_epochs=1, image_hw=16, lr=0.01)
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jtask = dataclasses.replace(JAX_CIFAR10, **FIXTURE)
    task = dataclasses.replace(CIFAR10, **FIXTURE)
    gen = SyntheticImageTask(task.num_classes, hw=task.image_hw, seed=0)
    shards = [gen.generate(n, seed=100 + i) for i, n in enumerate(SIZES)]
    tx, ty = gen.generate(64, seed=999)
    label_matrix = np.zeros((len(SIZES), task.num_classes))
    jdata = JaxFederatedData([JaxClientData(x, y) for x, y in shards], tx, ty,
                             label_matrix)
    data = FederatedData([ClientData(x, y) for x, y in shards], tx, ty,
                         label_matrix)
    init = jax.tree_util.tree_map(
        np.asarray, jax_make_model(jtask, width=8).init(jax.random.PRNGKey(1)))
    return jtask, jdata, task, data, init


def _run_port(monkeypatch, task, data, init, name):
    real = modelzoo.make_model

    def with_reference_init(*args, **kwargs):
        bundle = real(*args, **kwargs)
        return dataclasses.replace(
            bundle, init=lambda gen: bridge.params_from_numpy(init))

    monkeypatch.setattr(fl_loop, "make_model", with_reference_init)
    return fl_loop.run_federated(task, algorithms.make(name), data, seed=0,
                                 width=8, device="cpu")


def _max_diff(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(la, lb))


@pytest.mark.parametrize("name", ["fedavg", "fedgkd"])
def test_run_federated_matches_reference(setup, monkeypatch, name):
    jtask, jdata, task, data, init = setup
    hj = jax_fl.run_federated(jtask, jax_algorithms.make(name), jdata,
                              seed=0, width=8, executor="vmap")
    assert hj.telemetry["round_body"] == "client_batched"
    ht = _run_port(monkeypatch, task, data, init, name)
    assert ht.telemetry["round_body"] == "client_batched"
    assert [r.sampled for r in ht.records] == [r.sampled for r in hj.records]
    final = bridge.params_to_numpy(ht.final_params)
    assert _max_diff(final, hj.final_params) < TOL
    for rt, rj in zip(ht.records, hj.records, strict=True):
        assert abs(rt.mean_local_loss - rj.mean_local_loss) < TOL
        assert abs(rt.test_acc - rj.test_acc) < TOL
        assert abs(rt.test_loss - rj.test_loss) < TOL


def test_fedgkd_inline_teacher_matches_precompute(setup):
    """``FedGKD.batched_loss_fn`` on a client-stacked cohort: the teacher
    run inline (folded over the cohort) and its precomputed logits as
    ``aux`` give the reference's per-client losses."""
    jtask, _, task, data, init = setup
    jalgo, algo = jax_algorithms.make("fedgkd"), algorithms.make("fedgkd")
    jmodel = jax_make_model(jtask, width=8)
    model = modelzoo.make_model(task, width=8)
    rng = np.random.default_rng(4)
    k = 3
    stacked = jax.tree_util.tree_map(
        lambda a: np.stack([a + 0.05 * i * rng.standard_normal(a.shape)
                            .astype(np.float32) for i in range(k)]), init)
    x = np.stack([data.clients[i].x[:5] for i in range(k)])
    y = np.stack([data.clients[i].y[:5] for i in range(k)])
    mask = np.ones((k, 5), np.float32)
    mask[1, 3:] = 0.0
    _, jper = jax.jit(jalgo.batched_loss_fn(jmodel))(
        stacked, {"teacher": init}, (), x, y, mask)

    loss = algo.batched_loss_fn(model)
    params = bridge.params_from_numpy(stacked)
    payload = {"teacher": bridge.params_from_numpy(init)}
    tx, ty, tm = (torch.from_numpy(a) for a in (x, y, mask))
    _, inline = loss(params, payload, (), tx, ty, tm)
    aux = algo.precompute_aux(model, payload, tx.reshape((-1,) + x.shape[2:]),
                              None, None)
    aux = {"t_logits": aux["t_logits"].reshape(k, 5, -1)}
    _, pre = loss(params, payload, (), tx, ty, tm, aux)
    np.testing.assert_allclose(inline.detach().numpy(), np.asarray(jper),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(pre.detach().numpy(), np.asarray(jper),
                               rtol=0, atol=TOL)


def test_fedgkd_single_client_loss_matches_reference(setup):
    """``FedGKD.loss_fn`` (one client, teacher inline and from aux): value
    and student gradient against the reference's."""
    jtask, _, task, data, init = setup
    jalgo, algo = jax_algorithms.make("fedgkd"), algorithms.make("fedgkd")
    jmodel = jax_make_model(jtask, width=8)
    model = modelzoo.make_model(task, width=8)
    rng = np.random.default_rng(3)
    teacher = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        init)
    x, y = data.clients[3].x[:8], data.clients[3].y[:8]
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32)

    jloss = jalgo.loss_fn(jmodel)
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        init, {"teacher": teacher}, (), x, y, mask)
    params = bridge.params_from_numpy(init)
    leaves = jax.tree_util.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = algo.loss_fn(model)
    payload = {"teacher": bridge.params_from_numpy(teacher)}
    tl, _ = loss(params, payload, (), torch.from_numpy(x),
                 torch.from_numpy(y), torch.from_numpy(mask))
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) < TOL
    grads = jax.tree_util.tree_map(lambda p: p.grad.numpy(), params)
    assert _max_diff(grads, jg) < TOL
    # aux (precomputed teacher logits) gives the same value as inline
    aux = algo.precompute_aux(model, payload, torch.from_numpy(x), None, None)
    ta, _ = loss(params, payload, (), torch.from_numpy(x),
                 torch.from_numpy(y), torch.from_numpy(mask), aux)
    assert abs(float(ta.detach()) - float(tl.detach())) < TOL


def test_auto_sequential_cohort_of_one_matches_reference(setup, monkeypatch):
    """A cohort of 1 takes the sequential executor in both packages
    (``executor="auto"``); 2 FedGKD rounds agree as the batched ones do."""
    jtask, jdata, task, data, init = setup
    jtask, task = (dataclasses.replace(t, participation=1 / len(SIZES))
                   for t in (jtask, task))
    hj = jax_fl.run_federated(jtask, jax_algorithms.make("fedgkd"), jdata,
                              seed=0, width=8)
    ht = _run_port(monkeypatch, task, data, init, "fedgkd")
    assert hj.telemetry["route"] == ht.telemetry["route"] == "sequential"
    assert [r.sampled for r in ht.records] == [r.sampled for r in hj.records]
    assert len(ht.records[0].sampled) == 1
    assert _max_diff(bridge.params_to_numpy(ht.final_params),
                     hj.final_params) < TOL
    for rt, rj in zip(ht.records, hj.records, strict=True):
        assert abs(rt.mean_local_loss - rj.mean_local_loss) < TOL
        assert abs(rt.test_acc - rj.test_acc) < TOL


def test_model_buffer_contract():
    from repro_torch.core.server import ModelBuffer
    buf = ModelBuffer(2)
    a = {"w": torch.ones(3)}
    assert buf.push(a)
    assert not buf.push({"w": torch.ones(3)})          # bitwise duplicate
    assert buf.push({"w": torch.full((3,), 3.0)})
    assert buf.push({"w": torch.full((3,), 5.0)})      # evicts the first
    assert buf.versions == [2, 1]
    torch.testing.assert_close(buf.fused()["w"], torch.full((3,), 4.0))
    with pytest.raises(ValueError, match="non-finite"):
        buf.push({"w": torch.tensor([0.0, float("nan"), 1.0])})


@pytest.mark.parametrize("kwargs,item", [
    (dict(population=object()), "A12"),
    (dict(population=object(), executor="async"), "A12"),
    (dict(population=object(), faults=object()), "A12"),
    (dict(executor="shard_map"), "A13")])
def test_unported_options_raise(setup, kwargs, item):
    _, _, task, data, _ = setup
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        fl_loop.run_federated(task, algorithms.make("fedavg"), data,
                              device="cpu", **kwargs)
