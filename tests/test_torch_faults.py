"""Fault-tolerant rounds in the port, against the JAX reference on the CPU.

The fixture is the reference's own (``tests/test_faults.py``): the TOY
task's MLP over six ragged clients (``RAGGED_SIZES``), batch 64, two local
epochs, every client sampled.  The port starts from the reference's
initialisation (through the bridge) and draws cohorts, batches, speeds and
faults from the same seeds, so:

  * the fault injector's draws equal the reference's number for number;
  * under the reference's ``CHAOS`` profile (20% crashes, 5% corrupt
    uploads) the fault counters equal the reference's and a 2-round
    trajectory agrees to 1e-5 (fp32, different summation orders);
  * a zero-probability profile is bit-identical to ``faults=None``.

Beside them: ``FaultProfile`` validation, the three corruption modes and
where the port's poison lands, the ``validate_update`` gates, the backoff
cap, a total crash holding the global, and corrupt uploads kept out of the
teacher buffer.  The helpers at the top are shared with
``test_torch_async.py`` and ``test_torch_privacy_checkpoint.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs.paper import CIFAR10 as JAX_CIFAR10  # noqa: E402
from repro.configs.paper import TOY as JAX_TOY  # noqa: E402
from repro.core import algorithms as jax_algorithms  # noqa: E402
from repro.core import fl_loop as jax_fl  # noqa: E402
from repro.core import server as jax_server  # noqa: E402
from repro.core import systemsim as jax_sim  # noqa: E402
from repro.core.modelzoo import make_model as jax_make_model  # noqa: E402
from repro.data.pipeline import ClientData as JaxClientData  # noqa: E402
from repro.data.pipeline import FederatedData as JaxFederatedData  # noqa: E402
from repro.data.synthetic import SyntheticTabularTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.paper import CIFAR10, TOY  # noqa: E402
from repro_torch.core import algorithms, fl_loop, modelzoo  # noqa: E402
from repro_torch.core.server import (FaultPolicy, ModelBuffer,  # noqa: E402
                                     first_nonfinite_path, validate_update)
from repro_torch.core.systemsim import (CORRUPT_MODES,  # noqa: E402
                                        FaultInjector, FaultProfile,
                                        corrupt_params, derive_fault_rng,
                                        derive_rng)
from repro_torch.data.pipeline import ClientData, FederatedData  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves  # noqa: E402

RAGGED_SIZES = (20, 45, 64, 100, 130, 150)
FIXTURE = dict(n_clients=len(RAGGED_SIZES), participation=1.0,
               batch_size=64, rounds=2, local_epochs=2)
CHAOS = FaultProfile(crash_prob=0.2, corrupt_prob=0.05)
JAX_CHAOS = jax_sim.FaultProfile(crash_prob=0.2, corrupt_prob=0.05)
TOL = 1e-5
# the fields a resumed or zero-fault run must reproduce exactly
REC_FIELDS = ("round", "test_acc", "test_loss", "mean_local_loss",
              "sim_time", "version", "mean_staleness", "sampled")


@functools.lru_cache(maxsize=None)
def ragged_data():
    """(reference task, reference data, port task, port data)."""
    jtask = dataclasses.replace(JAX_TOY, **FIXTURE)
    task = dataclasses.replace(TOY, **FIXTURE)
    gen = SyntheticTabularTask(task.num_classes, dim=task.feat_dim, seed=0)
    shards = [gen.generate(n, seed=100 + i)
              for i, n in enumerate(RAGGED_SIZES)]
    tx, ty = gen.generate(200, seed=999)
    labels = np.zeros((len(RAGGED_SIZES), task.num_classes))
    return (jtask, JaxFederatedData([JaxClientData(*s) for s in shards], tx,
                                    ty, labels),
            task, FederatedData([ClientData(*s) for s in shards], tx, ty,
                                labels))


@functools.lru_cache(maxsize=None)
def reference_init(seed: int):
    """The reference's MLP init at ``run_federated``'s key, as numpy."""
    return jax.tree_util.tree_map(np.asarray, jax_make_model(
        ragged_data()[0]).init(jax.random.PRNGKey(seed + 1)))


def run_port(monkeypatch, algo, *, seed, **kw):
    """The port's ``run_federated`` on the fixture from the reference's
    init, on the CPU."""
    real = modelzoo.make_model
    init = reference_init(seed)

    def with_reference_init(*args, **kwargs):
        return dataclasses.replace(
            real(*args, **kwargs),
            init=lambda gen: bridge.params_from_numpy(init))

    monkeypatch.setattr(fl_loop, "make_model", with_reference_init)
    _, _, task, data = ragged_data()
    return fl_loop.run_federated(task, algo, data, seed=seed, device="cpu",
                                 **kw)


def run_own(algo, *, seed, **kw):
    """The port's ``run_federated`` on the fixture from its own init."""
    _, _, task, data = ragged_data()
    return fl_loop.run_federated(task, algo, data, seed=seed, device="cpu",
                                 **kw)


def run_reference(jalgo, *, seed, **kw):
    jtask, jdata, _, _ = ragged_data()
    return jax_fl.run_federated(jtask, jalgo, jdata, seed=seed, **kw)


def max_diff(port_params, ref_params) -> float:
    la = jax.tree_util.tree_leaves(bridge.params_to_numpy(port_params))
    lb = jax.tree_util.tree_leaves(ref_params)
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
               for a, b in zip(la, lb))


def assert_matches_reference(ht, hj, tol=TOL):
    """Same cohorts and virtual clock, exactly; params, losses and
    accuracies within ``tol``."""
    assert len(ht.records) == len(hj.records)
    for rt, rj in zip(ht.records, hj.records):
        for f in ("round", "sim_time", "version", "mean_staleness",
                  "sampled"):
            assert getattr(rt, f) == getattr(rj, f), (rt.round, f)
        for f in ("mean_local_loss", "test_acc", "test_loss"):
            assert abs(getattr(rt, f) - getattr(rj, f)) < tol, (rt.round, f)
    assert max_diff(ht.final_params, hj.final_params) < tol


def assert_histories_identical(a, b):
    """Bit for bit: every record field and every parameter."""
    assert len(a.records) == len(b.records)
    for ra, rb in zip(a.records, b.records):
        for f in REC_FIELDS:
            assert getattr(ra, f) == getattr(rb, f), (ra.round, f)
    for x, y in zip(tree_leaves(a.final_params), tree_leaves(b.final_params),
                    strict=True):
        assert torch.equal(x, y)


# ------------------------------------------------------------------ units

def test_fault_profile_validates():
    with pytest.raises(ValueError):
        FaultProfile(crash_prob=-0.1)
    with pytest.raises(ValueError):
        FaultProfile(crash_prob=0.7, timeout_prob=0.4)      # sums past 1
    with pytest.raises(ValueError):
        FaultProfile(corrupt_prob=0.1, corrupt_modes=("nan", "bogus"))
    with pytest.raises(ValueError):
        FaultProfile(host_crash_prob=1.5)
    assert not FaultProfile().any
    assert FaultProfile(crash_prob=0.01).any


def test_injector_draws_equal_the_reference():
    """1,000 draws from one seed: the same faults, modes and counters."""
    kw = dict(crash_prob=0.2, timeout_prob=0.1, corrupt_prob=0.1)
    port = FaultInjector(FaultProfile(**kw), derive_fault_rng(7))
    ref = jax_sim.FaultInjector(jax_sim.FaultProfile(**kw),
                                jax_sim.derive_fault_rng(7))
    seq = [port.draw() for _ in range(1000)]
    assert seq == [ref.draw() for _ in range(1000)]
    assert {f[0] for f in seq if f is not None} == {"crash", "timeout",
                                                    "corrupt"}
    assert port.counters == ref.counters


def test_streams_equal_the_reference_and_each_other_not():
    for seed in (0, 3, 11):
        np.testing.assert_array_equal(derive_rng(seed).random(16),
                                      jax_sim.derive_rng(seed).random(16))
        np.testing.assert_array_equal(
            derive_fault_rng(seed).random(16),
            jax_sim.derive_fault_rng(seed).random(16))
    assert not np.allclose(derive_fault_rng(3).random(8),
                           derive_rng(3).random(8))


def test_zero_profile_never_fires_but_advances_the_stream():
    inj = FaultInjector(FaultProfile(), derive_fault_rng(0))
    assert all(inj.draw() is None for _ in range(50))
    assert inj.counters == {"crashes": 0, "timeouts": 0,
                            "corrupt_injected": 0, "host_crashes": 0}
    fresh = derive_fault_rng(0)
    fresh.random(50)
    assert inj.rng.random() == fresh.random()


@pytest.mark.parametrize("mode", CORRUPT_MODES)
def test_corrupt_params_modes(mode):
    params = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
    bad = corrupt_params(params, mode)
    ok, reason = validate_update(bad, params)
    assert not ok
    if mode in ("nan", "inf"):
        assert reason.startswith("nonfinite:")
        # the first leaf in flatten order (sorted keys): "b"
        assert first_nonfinite_path(bad) == "b"
    else:
        assert first_nonfinite_path(bad) is None
        assert reason.startswith("norm:")
    assert first_nonfinite_path(params) is None     # the input is untouched


@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_poison_lands_on_the_ports_first_leaf(mode):
    """ResNet-8 at width 4 from the port's own init: the poison is element
    [0, ..., 0] of the first leaf in flatten order, and only that element;
    the gate names that leaf's path, the same path the reference's gate
    names for its own ResNet-8 (the port keeps its keys and sorted
    order)."""
    params = modelzoo.make_model(CIFAR10, width=4).init(
        torch.Generator().manual_seed(0))
    bad = corrupt_params(params, mode)
    first = tree_flatten(bad)[0][0]
    assert not torch.isfinite(first[(0,) * first.ndim])
    assert int((~torch.isfinite(first)).sum()) == 1
    for x, y in zip(tree_flatten(bad)[0][1:], tree_flatten(params)[0][1:]):
        assert torch.equal(x, y)
    jinit = jax_make_model(JAX_CIFAR10, width=4).init(jax.random.PRNGKey(0))
    ok, reason = validate_update(bad, params)
    jok, jreason = jax_server.validate_update(
        jax_sim.corrupt_params(jinit, mode), jinit)
    assert not ok and not jok
    assert reason == jreason


def test_validate_update_gates_match_the_reference():
    rng = np.random.default_rng(0)
    ref = {"w": rng.standard_normal(8).astype(np.float32),
           "b": np.full(3, 0.1, np.float32)}
    for scale, mult in ((1.5, 10.0), (1e4, 10.0), (1e4, 1e6), (0.01, 10.0)):
        cand = {k: v * scale for k, v in ref.items()}
        got = validate_update(bridge.params_from_numpy(cand),
                              bridge.params_from_numpy(ref),
                              max_norm_mult=mult)
        assert got == jax_server.validate_update(cand, ref,
                                                 max_norm_mult=mult)
    # the floor of 1.0: a near-zero reference rejects nothing ordinary
    tiny = {"w": torch.full((4,), 1e-6)}
    assert validate_update({"w": torch.ones(4)}, tiny) == (True, "ok")


def test_fault_policy_backoff_caps():
    pol = FaultPolicy(backoff_base=1.0, backoff_cap=30.0)
    jpol = jax_server.FaultPolicy(backoff_base=1.0, backoff_cap=30.0)
    waits = [pol.backoff(k) for k in range(1, 9)]
    assert waits == [jpol.backoff(k) for k in range(1, 9)]
    assert waits[:3] == [1.0, 2.0, 4.0] and max(waits) == 30.0
    assert waits == sorted(waits)
    with pytest.raises(ValueError):
        FaultPolicy(quorum_frac=0.0)
    with pytest.raises(ValueError):
        FaultPolicy(max_retries=-1)


def test_model_buffer_rejects_nonfinite_push():
    buf = ModelBuffer(3)
    with pytest.raises(ValueError, match="w"):
        buf.push({"w": torch.tensor([1.0, float("nan")])})
    assert len(buf) == 0 and buf.versions == []


# ---------------------------------------------------- runs of the loop

@pytest.mark.parametrize("spec", ["sequential", "vmap", "async"])
def test_zero_prob_faults_bit_identical(spec):
    """The fault machinery with every probability 0 moves no bit: the
    injector draws from its own stream."""
    from repro_torch.core.executor import AsyncExecutor

    def route():
        return (AsyncExecutor(buffer_size=3, staleness="fedgkd")
                if spec == "async" else spec)

    base = run_own(algorithms.make("fedgkd", buffer_m=3), seed=0,
                   executor=route())
    gated = run_own(algorithms.make("fedgkd", buffer_m=3), seed=0,
                    executor=route(), faults=FaultProfile())
    assert_histories_identical(base, gated)
    assert gated.telemetry["faults"]["crashes"] == 0


@pytest.mark.parametrize("name,spec,kw", [
    ("fedavg", "sequential", {}),
    ("fedgkd", "vmap", {"buffer_m": 3}),
    ("fedgkd-vote", "vmap", {"buffer_m": 3})])
def test_chaos_matches_reference(monkeypatch, name, spec, kw):
    """CHAOS over 2 rounds (seed 12 fires crashes, a NaN/Inf and a
    norm-outlier upload, and a retry): the fault counters equal the
    reference's, and the trajectory agrees to 1e-5."""
    hj = run_reference(jax_algorithms.make(name, **kw), seed=12,
                       executor=spec, faults=JAX_CHAOS)
    ht = run_port(monkeypatch, algorithms.make(name, **kw), seed=12,
                  executor=spec, faults=CHAOS)
    assert ht.telemetry["faults"] == hj.telemetry["faults"]
    for key in ("crashes", "rejected_nonfinite", "rejected_norm", "retries"):
        assert hj.telemetry["faults"][key] > 0, key
    assert_matches_reference(ht, hj)


def test_faults_identical_across_sync_routes():
    outs = [run_own(algorithms.make("fedavg"), seed=11, rounds=3,
                    executor=spec, faults=CHAOS)
            for spec in ("sequential", "vmap")]
    assert outs[0].telemetry["faults"] == outs[1].telemetry["faults"]
    for a, b in zip(outs[0].records, outs[1].records):
        assert a.sampled == b.sampled
        assert abs(a.test_acc - b.test_acc) < TOL


def test_total_crash_skips_rounds_and_holds_global():
    """Every client crashes through every retry: the rounds are recorded
    as skipped and the global is held, not zeroed."""
    h = run_own(algorithms.make("fedavg"), seed=0, executor="sequential",
                faults=FaultProfile(crash_prob=1.0),
                fault_policy=FaultPolicy(max_retries=1))
    init = run_own(algorithms.make("fedavg"), seed=0, rounds=0)
    ftel = h.telemetry["faults"]
    assert ftel["skipped_rounds"] == 2 and ftel["quorum_shortfalls"] == 2
    assert ftel["crashes"] == 2 * 2 * len(RAGGED_SIZES)
    for x, y in zip(tree_leaves(h.final_params),
                    tree_leaves(init.final_params), strict=True):
        assert torch.equal(x, y)
    assert h.records[0].test_acc == h.records[1].test_acc
    assert h.records[0].mean_local_loss == 0.0


def test_corrupt_teacher_never_reaches_buffer():
    """Heavy corruption: every corrupt upload is rejected by the gate, so
    the teacher buffer only ever holds finite models."""
    pushed = []
    algo = algorithms.make("fedgkd", buffer_m=3)
    real_update = algo.server_update

    def watch(*args, **kwargs):
        server = real_update(*args, **kwargs)
        pushed.append([first_nonfinite_path(m)
                       for m in server["buffer"].models])
        return server

    algo.server_update = watch
    h = run_own(algo, seed=2, rounds=4, executor="vmap",
                faults=FaultProfile(corrupt_prob=0.4))
    ftel = h.telemetry["faults"]
    assert ftel["corrupt_injected"] > 0
    assert (ftel["rejected_nonfinite"] + ftel["rejected_norm"]
            == ftel["corrupt_injected"])
    assert pushed and all(p is None for ps in pushed for p in ps)
    assert first_nonfinite_path(h.final_params) is None
    assert all(np.isfinite(r.test_loss) for r in h.records)


def test_host_faults_and_population_raise_naming_the_roadmap():
    _, _, task, data = ragged_data()
    with pytest.raises(NotImplementedError, match="A13"):
        fl_loop.run_federated(task, algorithms.make("fedavg"), data,
                              device="cpu",
                              faults=FaultProfile(host_crash_prob=0.1))
