"""The paper's baselines that train client-batched, end to end against the
JAX reference on the CPU: FedProx, FedGKD with the MSE loss (Table 9),
FedGKD-VOTE (Eq. 5) and FedGKD+ (the projection-head model).

2 rounds of ``run_federated`` over 6 ragged clients (the fixture of
``tests/test_torch_fl.py``: 16x16 images, width 8, batch 8, lr 0.01),
``executor="auto"``, which picks the vmap executor's client-batched route
in both packages.  Both start from the reference's initialisation (the
port's is replaced through the bridge) and draw cohorts and batches from
the same numpy seed: the cohorts must be identical, and the final params,
each round's mean local loss, test accuracy and test loss within 1e-5
(fp32, different summation orders).  FedGKD-VOTE's validation losses and
vote coefficients are held to the same bar every round.
"""
import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

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
from torch_threads import one_torch_thread  # noqa: E402,F401

SIZES = (5, 9, 12, 20, 8, 16)       # ragged, as tests/test_executor.py
FIXTURE = dict(n_clients=len(SIZES), participation=1.0, batch_size=8,
               rounds=2, local_epochs=1, image_hw=16, lr=0.01)
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def fixture_data():
    """(reference task, reference data, port task, port data)."""
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
    return jtask, jdata, task, data


@functools.lru_cache(maxsize=None)
def reference_init(projection_head: bool):
    """The reference's ResNet-8 init at the fixture's width, as numpy."""
    jtask = fixture_data()[0]
    return jax.tree_util.tree_map(np.asarray, jax_make_model(
        jtask, projection_head=projection_head, width=8).init(
            jax.random.PRNGKey(1)))


def run_port(monkeypatch, algo, init, **kwargs):
    """The port's ``run_federated`` on the fixture from ``init``."""
    task, data = fixture_data()[2:]
    real = modelzoo.make_model

    def with_reference_init(*args, **kw):
        bundle = real(*args, **kw)
        return dataclasses.replace(
            bundle, init=lambda gen: bridge.params_from_numpy(init))

    monkeypatch.setattr(fl_loop, "make_model", with_reference_init)
    return fl_loop.run_federated(task, algo, data, seed=0, width=8,
                                 device="cpu", **kwargs)


def run_reference(algo, **kwargs):
    jtask, jdata = fixture_data()[:2]
    return jax_fl.run_federated(jtask, algo, jdata, seed=0, width=8, **kwargs)


def max_diff(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(la, lb))


def assert_trajectories_match(ht, hj, tol=TOL):
    """Identical cohorts; final params, mean local losses, test accuracy
    and test loss within ``tol``."""
    assert [r.sampled for r in ht.records] == [r.sampled for r in hj.records]
    assert max_diff(bridge.params_to_numpy(ht.final_params),
                    hj.final_params) < tol
    for rt, rj in zip(ht.records, hj.records, strict=True):
        assert abs(rt.mean_local_loss - rj.mean_local_loss) < tol
        assert abs(rt.test_acc - rj.test_acc) < tol
        assert abs(rt.test_loss - rj.test_loss) < tol


SPECS = [("fedprox", {}), ("fedgkd", {"loss_type": "mse"}),
         ("fedgkd-vote", {}), ("fedgkd+", {})]


@pytest.mark.parametrize("name,kw", SPECS, ids=[s[0] + "-" + "-".join(
    map(str, s[1].values())) if s[1] else s[0] for s in SPECS])
def test_batched_baseline_matches_reference(monkeypatch, name, kw):
    jalgo = jax_algorithms.make(name, **kw)
    algo = algorithms.make(name, **kw)
    assert algo.needs_projection_head == jalgo.needs_projection_head
    init = reference_init(algo.needs_projection_head)
    hj = run_reference(jalgo)
    ht = run_port(monkeypatch, algo, init)
    assert hj.telemetry["route"] == ht.telemetry["route"] == "vmap"
    assert ht.telemetry["round_body"] == hj.telemetry["round_body"] \
        == "client_batched"
    assert_trajectories_match(ht, hj)


def test_fedgkd_vote_coefficients_follow_reference(monkeypatch):
    """FedGKD-VOTE's per-model validation losses (on the loop's
    ``test[:n_val]`` split) and the γ_m they vote, after every round."""
    seen = {"ref": [], "port": []}

    def recorder(key, algo):
        def cb(t, server, model):
            payload = (algo.round_payload(server, None) if key == "ref"
                       else algo.round_payload(server))
            seen[key].append((list(server["val_losses"]),
                              np.asarray(payload["gammas"]),
                              np.asarray(payload["teacher_versions"])))
        return cb

    jalgo = jax_algorithms.make("fedgkd-vote", buffer_m=3)
    algo = algorithms.make("fedgkd-vote", buffer_m=3)
    run_reference(jalgo, round_callback=recorder("ref", jalgo))
    run_port(monkeypatch, algo, reference_init(False),
             round_callback=recorder("port", algo))
    assert len(seen["port"]) == len(seen["ref"]) == FIXTURE["rounds"]
    for (lt, gt, vt), (lj, gj, vj) in zip(seen["port"], seen["ref"]):
        assert len(lt) == len(lj) > 1          # one loss per buffered model
        np.testing.assert_allclose(lt, lj, rtol=0, atol=TOL)
        np.testing.assert_allclose(gt, gj, rtol=0, atol=TOL)
        np.testing.assert_array_equal(vt, vj)
        assert gt.shape == (3,)
