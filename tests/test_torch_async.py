"""The buffered-asynchronous executor in the port, against the JAX
reference on the CPU.

On the TOY fixture of ``test_torch_faults.py`` (six ragged clients, all in
flight), with a straggler speed profile and staggered availability:

  * the staleness weights equal the reference's (hypothesis);
  * ``SystemSim`` pops the reference's completions in the reference's order
    at the same virtual times, and ``state``/``restore`` continue it;
  * async histories under the ``polynomial`` and ``fedgkd`` schemes, with
    the vmap and the sequential inner, have the reference's ``sim_time``,
    ``version``, ``mean_staleness`` and ``sampled`` exactly and its params
    to 1e-5; under ``CHAOS`` faults also its fault counters.  The
    reference runs its default fixed-slot waves (``wave_slots="auto"``),
    the port variable ones (eager PyTorch compiles nothing per shape);
  * the pipelined loop (deferred losses, refill before evaluation) agrees
    with the single-stream one to 1e-5;
  * ``absorb_stale`` pushes one buffer version (FedGKD), keeps FedGKD-VOTE's
    validation losses aligned, and costs the part cache one recompute;
  * async with faults, killed after an aggregation and resumed, is bit for
    bit the uninterrupted run;
  * ``launch.train.make_round_clock`` equals the reference's;
  * one aggregation of ResNet-8 at width 4 on the client-batched route
    agrees with the reference's to 1e-5.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.core import algorithms as jax_algorithms  # noqa: E402
from repro.core import executor as jax_executor  # noqa: E402
from repro.core import fl_loop as jax_fl  # noqa: E402
from repro.core import server as jax_server  # noqa: E402
from repro.core import systemsim as jax_sim  # noqa: E402
from repro.core.modelzoo import make_model as jax_make_model  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import algorithms, executor, fl_loop  # noqa: E402
from repro_torch.core import modelzoo, server  # noqa: E402
from repro_torch.core import systemsim as port_sim  # noqa: E402
from repro_torch.core.systemsim import (Availability, SpeedProfile,  # noqa: E402
                                        SystemSim, derive_rng)
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from test_torch_baselines_batched import fixture_data  # noqa: E402
from test_torch_faults import (CHAOS, JAX_CHAOS, TOL,  # noqa: E402
                               assert_histories_identical,
                               assert_matches_reference, max_diff,
                               ragged_data, run_own, run_port,
                               run_reference)
from torch_threads import one_torch_thread  # noqa: E402,F401

ASYNC_KW = dict(staleness_cutoff=4, staleness_a=0.5)


def port_async(buffer_size=3, staleness="fedgkd", inner="vmap", **kw):
    return executor.AsyncExecutor(
        buffer_size=buffer_size, staleness=staleness, inner=inner,
        profile=SpeedProfile(kind="straggler", straggler_frac=0.25),
        availability=Availability(period=24.0, duty=0.8), **ASYNC_KW, **kw)


def reference_async(buffer_size=3, staleness="fedgkd", inner="vmap"):
    return jax_executor.AsyncExecutor(
        buffer_size=buffer_size, staleness=staleness, inner=inner,
        profile=jax_sim.SpeedProfile(kind="straggler", straggler_frac=0.25),
        availability=jax_sim.Availability(period=24.0, duty=0.8),
        **ASYNC_KW)


# ------------------------------------------------------- staleness weights

@settings(max_examples=60, deadline=None, database=None)
@given(st.lists(st.tuples(st.floats(0.5, 500.0), st.integers(0, 9)),
                min_size=1, max_size=10),
       st.sampled_from(server.STALENESS_SCHEMES), st.floats(0.0, 3.0),
       st.one_of(st.none(), st.integers(0, 5)), st.booleans())
def test_staleness_weights_equal_the_reference(pairs, scheme, a, cutoff,
                                               normalize):
    ws, stale = [p[0] for p in pairs], [p[1] for p in pairs]
    got = server.async_aggregation_weights(ws, stale, scheme, a=a,
                                           cutoff=cutoff, normalize=normalize)
    assert got == jax_server.async_aggregation_weights(
        ws, stale, scheme, a=a, cutoff=cutoff, normalize=normalize)
    assert all(w >= 0.0 for w in got)
    if normalize:
        assert abs(sum(got) - 1.0) < 1e-9
    scales = [server.staleness_scale(s, "polynomial", a=a)
              for s in sorted(stale)]
    assert all(x >= y for x, y in zip(scales, scales[1:]))


def test_staleness_cutoff_fallback_and_errors():
    assert server.staleness_scale(3, "fedgkd", cutoff=2) == 0.0
    assert server.staleness_scale(2, "fedgkd", cutoff=2) > 0.0
    np.testing.assert_allclose(server.async_aggregation_weights(
        [10.0, 30.0], [5, 9], "fedgkd", cutoff=2), [0.25, 0.75])
    with pytest.raises(ValueError):
        server.staleness_scale(1, "nope")
    with pytest.raises(ValueError):
        server.staleness_scale(-1)


# ---------------------------------------------------------------- SystemSim

@pytest.mark.parametrize("kind,avail", [("straggler", True),
                                        ("lognormal", False),
                                        ("uniform", True),
                                        ("homogeneous", False)])
def test_system_sim_equals_the_reference(kind, avail):
    """Same seed, same dispatches: the same speeds and phases, completions
    popped in the same order at the same times, the same clock and
    counters; and a snapshot restored into a fresh sim continues as the
    reference does."""
    def build(mod):
        av = mod.Availability(period=16.0, duty=0.6) if avail else None
        return mod.SystemSim(8, mod.SpeedProfile(kind=kind), availability=av,
                             rng=mod.derive_rng(5))

    port, ref = build(port_sim), build(jax_sim)
    np.testing.assert_array_equal(port.speeds, ref.speeds)
    draws = np.random.default_rng(0)
    for c in range(8):
        w = float(draws.uniform(0.5, 8.0))
        assert port.dispatch(c, w, tag={"c": c}) == ref.dispatch(c, w)

    def step(sim, rng):
        comp = sim.pop()
        sim.dispatch(comp.client, float(rng.uniform(0.5, 8.0)),
                     delay=float(rng.uniform(0.0, 2.0)))
        return comp.time, comp.seq, comp.client

    rp, rr = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(20):
        assert step(port, rp) == step(ref, rr)
    # a sim of the same configuration, from another seed: the snapshot
    # brings back the speeds, phases, clock, heap and counters
    av = Availability(period=16.0, duty=0.6) if avail else None
    fresh = SystemSim(8, SpeedProfile(kind=kind), availability=av,
                      rng=derive_rng(99))
    fresh.restore(port.state())
    for _ in range(20):
        assert step(fresh, rp) == step(ref, rr)
    assert fresh.now == ref.now and fresh.stats() == ref.stats()


def test_sim_state_moves_tags_to_the_host_and_back():
    sim = SystemSim(3, rng=derive_rng(0))
    tag = {"upload": {"params": {"w": torch.arange(3.0)}}, "loss":
           torch.tensor(0.5), "weight": 4.0, "version": 1,
           "fault": ("corrupt", "nan")}
    sim.dispatch(1, 2.0, tag=tag)
    snap = sim.state()
    host = snap["heap"][0][3]
    assert isinstance(host["upload"]["params"]["w"], np.ndarray)
    assert isinstance(host["loss"], np.ndarray)
    again = SystemSim(3, rng=derive_rng(0))
    again.restore(snap, device="cpu")
    comp = again.pop()
    assert comp.client == 1 and comp.time == 2.0
    assert torch.equal(comp.tag["upload"]["params"]["w"], torch.arange(3.0))
    assert float(comp.tag["loss"]) == 0.5
    assert comp.tag["fault"] == ("corrupt", "nan")


# ------------------------------------------------ histories vs. reference

@pytest.mark.parametrize("staleness,inner", [("polynomial", "vmap"),
                                             ("fedgkd", "vmap"),
                                             ("fedgkd", "sequential"),
                                             ("polynomial", "sequential")])
def test_async_history_matches_reference(monkeypatch, staleness, inner):
    hj = run_reference(jax_algorithms.make("fedgkd", buffer_m=3), seed=4,
                       rounds=5, executor=reference_async(
                           staleness=staleness, inner=inner))
    ht = run_port(monkeypatch, algorithms.make("fedgkd", buffer_m=3), seed=4,
                  rounds=5, executor=port_async(staleness=staleness,
                                                inner=inner))
    assert_matches_reference(ht, hj)
    for key in ("route", "inner_route", "buffer_size", "staleness_scheme",
                "aggregations", "final_version", "stale_absorbed",
                "mean_staleness", "max_staleness", "sim"):
        assert ht.telemetry[key] == hj.telemetry[key], key
    assert ht.telemetry["max_staleness"] >= 1.0
    assert "compile_count" not in ht.telemetry


def test_async_chaos_matches_reference(monkeypatch):
    hj = run_reference(jax_algorithms.make("fedgkd", buffer_m=3), seed=4,
                       rounds=5, executor=reference_async(), faults=JAX_CHAOS)
    ht = run_port(monkeypatch, algorithms.make("fedgkd", buffer_m=3), seed=4,
                  rounds=5, executor=port_async(), faults=CHAOS)
    assert ht.telemetry["faults"] == hj.telemetry["faults"]
    assert hj.telemetry["faults"]["crashes"] > 0
    assert hj.telemetry["faults"]["redispatches"] > 0
    assert_matches_reference(ht, hj)


def test_async_telemetry_records_and_buffer_validation():
    h = run_own(algorithms.make("fedgkd"), seed=3, rounds=4,
                executor=executor.AsyncExecutor(
                    buffer_size=2, profile=SpeedProfile(kind="straggler")))
    t = h.telemetry
    assert (t["route"], t["inner_route"], t["buffer_size"]) == ("async",
                                                                "vmap", 2)
    assert t["sim"]["dispatches"] == 6 + 3 * 2   # the fleet and 3 refills
    assert t["sim"]["in_flight"] == 6 - 2        # no refill after the last
    assert [r.version for r in h.records] == [1, 2, 3, 4]
    sim_times = [r.sim_time for r in h.records]
    assert sim_times == sorted(sim_times) and sim_times[0] > 0.0
    assert all(len(r.sampled) == 2 for r in h.records)
    for bad in (0, 7):                  # the cohort is 6
        with pytest.raises(ValueError, match="buffer_size"):
            run_own(algorithms.make("fedavg"), seed=0, rounds=1,
                    executor=executor.AsyncExecutor(buffer_size=bad))


@pytest.mark.parametrize("algo", ["fedavg", "fedgkd", "fedgkd-vote"])
def test_pipelined_matches_single_stream(algo):
    kw = {"buffer_m": 3} if algo.startswith("fedgkd") else {}
    h_p = run_own(algorithms.make(algo, **kw), seed=5, rounds=6,
                  executor=port_async(pipelined=True))
    h_s = run_own(algorithms.make(algo, **kw), seed=5, rounds=6,
                  executor=port_async(pipelined=False, wave_slots="variable"))
    assert [r.sampled for r in h_p.records] == [r.sampled for r in h_s.records]
    for a, b in zip(h_p.records, h_s.records, strict=True):
        for f in ("test_acc", "test_loss", "mean_local_loss"):
            assert abs(getattr(a, f) - getattr(b, f)) < TOL
    assert max(float((x - y).abs().max()) for x, y in zip(
        tree_leaves(h_p.final_params), tree_leaves(h_s.final_params),
        strict=True)) < TOL


def test_deferred_wave_returns_device_losses():
    """With ``deferred`` set the vmap executor hands back its losses as one
    tensor, unread; the host floats are the undeferred ones."""
    _, _, task, data = ragged_data()
    algo = algorithms.make("fedgkd", buffer_m=3)
    model = modelzoo.make_model(task)
    gp = model.init(torch.Generator().manual_seed(0))
    srv = algo.init_server(gp, model, task.num_classes)
    out = []
    for deferred in (True, False):
        ctx = executor.RoundContext(
            algo=algo, model=model, opt=sgd(), lr=0.05, batch_size=64,
            epochs=1, device=torch.device("cpu"), deferred=deferred)
        out.append(executor.VmapExecutor().run_round(
            ctx, gp, algo.round_payload(srv), [(), ()], data.clients[:2],
            np.random.default_rng(0), client_ids=[0, 1]).local_losses)
    assert isinstance(out[0], torch.Tensor) and out[0].shape == (2,)
    assert out[0].tolist() == out[1]


def test_wave_slots_validation():
    for bad in ("sometimes", 0):
        with pytest.raises(ValueError, match="wave_slots"):
            executor.AsyncExecutor(wave_slots=bad)
        with pytest.raises(ValueError, match="wave_slots"):
            jax_executor.AsyncExecutor(wave_slots=bad)
    with pytest.raises(ValueError, match="nest"):
        executor.AsyncExecutor(inner="async")
    vmap, seq = executor.VmapExecutor(), executor.SequentialExecutor()
    for slots, want in (("auto", 3), ("variable", None), (None, None),
                        (5, 5)):
        assert executor.AsyncExecutor(wave_slots=slots).resolve_wave_slots(
            3, vmap) == want
        assert executor.AsyncExecutor(wave_slots=slots).resolve_wave_slots(
            3, seq) is None
    h = run_own(algorithms.make("fedavg"), seed=0, rounds=2,
                executor=port_async(wave_slots=4))
    assert len(h.records) == 2 and "compile_count" not in h.telemetry


# ----------------------------------------------------------- absorb_stale

def _toy_server(name, m=3):
    _, _, task, _ = ragged_data()
    algo = algorithms.make(name, buffer_m=m)
    model = modelzoo.make_model(task)
    gp = model.init(torch.Generator().manual_seed(0))
    return algo, model, gp, algo.init_server(gp, model, task.num_classes)


def test_absorb_stale_fuses_one_buffer_entry():
    algo, model, gp, srv = _toy_server("fedgkd")
    v0 = list(srv["buffer"].versions)

    def scaled(f):
        return tree_map(lambda p: p * f, gp)

    ups = [{"params": scaled(2.0)}, {"params": scaled(4.0)},
           {"params": scaled(1.0)}]
    srv = algo.absorb_stale(srv, ups, [0, 0, 0], [1.0, 1.0, 1.0])
    assert srv["buffer"].versions == v0
    srv = algo.absorb_stale(srv, ups, [2, 1, 0], [1.0, 3.0, 9.0])
    assert srv["buffer"].versions == [v0[0] + 1] + v0
    want = tree_map(lambda a, b: 0.25 * a + 0.75 * b, scaled(2.0), scaled(4.0))
    assert max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(srv["buffer"].models[0]), tree_leaves(want))) < 1e-6
    # a non-finite stale model is quarantined: no push
    bad = tree_map(lambda p: p * float("nan"), gp)
    srv = algo.absorb_stale(srv, [{"params": bad}], [3], [1.0])
    assert srv["buffer"].versions == [v0[0] + 1] + v0
    avg = algorithms.make("fedavg")
    s2 = avg.init_server(gp, model, 10)
    assert avg.absorb_stale(s2, ups, [3, 0, 0], [1.0, 1.0, 1.0]) is s2


def test_vote_absorb_keeps_val_losses_aligned():
    algo, model, gp, srv = _toy_server("fedgkd-vote")
    _, _, _, data = ragged_data()
    srv["buffer"].push(tree_map(lambda p: p * 1.01, gp))
    srv["val_losses"] = [0.5, 0.7]
    ups = [{"params": tree_map(lambda p: p * 2.0, gp)}]
    srv = algo.absorb_stale(srv, ups, [2], [1.0])
    assert len(srv["val_losses"]) == len(srv["buffer"])
    assert srv["val_losses"][0] == 0.7       # priced at the worst loss
    vx = torch.from_numpy(data.test_x[:16])
    vy = torch.from_numpy(data.test_y[:16])
    srv = algo.absorb_stale(srv, ups, [1], [1.0], model=model,
                            val_batch=(vx, vy))
    assert len(srv["val_losses"]) == len(srv["buffer"]) == 3
    before, newest = list(srv["val_losses"]), srv["buffer"].versions[0]
    srv = algo.absorb_stale(srv, [{"params": tree_map(lambda p: p * 3.0,
                                                      gp)}],
                            [3], [1.0], model=model, val_batch=(vx, vy))
    assert srv["buffer"].versions[0] == newest + 1      # full buffer
    assert len(srv["val_losses"]) == 3 and srv["val_losses"] != before
    assert algo.absorb_stale(srv, ups, [0], [1.0])["buffer"].versions[0] \
        == newest + 1
    payload = algo.round_payload(srv)
    assert payload["gammas"].shape == (3,)
    assert abs(float(payload["gammas"].sum()) - 2 * algo.lam) < 1e-5


def test_vote_part_cache_absorb_recomputes_exactly_one_part():
    algo, model, gp, srv = _toy_server("fedgkd-vote")
    _, _, task, data = ragged_data()
    for m in range(2):
        srv["buffer"].push(tree_map(lambda p: p * (1.0 + 0.01 * (m + 1)), gp))
    srv["val_losses"] = [0.1, 0.2, 0.3]
    ctx = executor.RoundContext(algo=algo, model=model, opt=sgd(), lr=0.05,
                                batch_size=64, epochs=1,
                                device=torch.device("cpu"))
    ex, rng, k = executor.VmapExecutor(), np.random.default_rng(0), 6
    payload0 = algo.round_payload(srv)
    for cohort in ([0, 1, 2, 3, 4, 5], [5, 4, 3, 2, 1, 0], [0, 2, 4],
                   [1, 3, 5]):
        ex.run_round(ctx, gp, payload0, [() for _ in cohort],
                     [data.clients[c] for c in cohort], rng,
                     client_ids=cohort)
    assert ctx.telemetry["parts_computed"] == 3
    srv = algo.absorb_stale(srv, [{"params": tree_map(lambda p: p * 1.1,
                                                      gp)}], [2], [1.0])
    payload1 = algo.round_payload(srv)
    for _ in range(2):
        ex.run_round(ctx, gp, payload1, [() for _ in range(k)], data.clients,
                     rng, client_ids=list(range(k)))
        assert ctx.telemetry["parts_computed"] == 4
    assert all(len(ctx.aux_cache[c]) <= 3 for c in range(k))


# ----------------------------------------------------- resume, async

def test_async_with_faults_resumes_bit_for_bit(tmp_path):
    """Checkpointed at every aggregation, the chaotic async run ended after
    aggregation 3 and resumed: the in-flight wave, its uploads and the
    retry counts come back, and the history is the uninterrupted one."""
    def mk():
        return algorithms.make("fedgkd-vote", buffer_m=3)

    full = run_own(mk(), seed=4, rounds=6, executor=port_async(),
                   faults=CHAOS)
    ck = str(tmp_path / "ck")

    class Killed(Exception):
        pass

    def kill_at_3(rnd, *_):
        if rnd == 3:
            raise Killed

    with pytest.raises(Killed):
        run_own(mk(), seed=4, rounds=6, executor=port_async(), faults=CHAOS,
                checkpoint_dir=ck, round_callback=kill_at_3)
    resumed = run_own(mk(), seed=4, rounds=6, executor=port_async(),
                      faults=CHAOS, checkpoint_dir=ck, resume=True)
    assert_histories_identical(full, resumed)
    assert full.telemetry["faults"] == resumed.telemetry["faults"]
    # a finished run extends: resume the 6-round directory to 8 rounds
    longer = run_own(mk(), seed=4, rounds=8, executor=port_async(),
                     faults=CHAOS)
    extended = run_own(mk(), seed=4, rounds=8, executor=port_async(),
                       faults=CHAOS, checkpoint_dir=ck, resume=True)
    assert_histories_identical(longer, extended)


def test_measure_step_time_is_the_median_of_synchronised_calls():
    calls = []

    def step(x):
        calls.append(1)
        return (x @ x.T).sum()

    t = port_sim.measure_step_time(step, torch.ones(64, 64), warmup=2,
                                   repeats=3)
    assert t > 0.0 and np.isfinite(t) and len(calls) == 5


# ------------------------------------------------------------ round clock

def test_make_round_clock_equals_the_reference():
    assert train.make_round_clock(4, straggler_frac=0.0,
                                  straggler_slowdown=4.0, seed=0) is None
    for n, frac, slow, seed in ((64, 0.3, 4.0, 0), (5, 0.5, 2.5, 3),
                                (2, 0.5, 4.0, 0)):
        got = train.make_round_clock(n, straggler_frac=frac,
                                     straggler_slowdown=slow, seed=seed)
        want = jax_train.make_round_clock(n, straggler_frac=frac,
                                          straggler_slowdown=slow, seed=seed)
        for work in (1, 3.0, 8.0):
            assert got(work) == want(work)
    clock = train.make_round_clock(64, straggler_frac=0.3,
                                   straggler_slowdown=4.0, seed=0)
    assert clock(8.0) == pytest.approx(32.0)


# ------------------------------------------------- ResNet-8, client-batched

def test_resnet8_async_aggregation_matches_reference(monkeypatch):
    """One FedGKD aggregation of ResNet-8 at width 4 (B3 and B1/B2 on the
    client-batched route): a wave of 6, then a buffer of 2."""
    jtask, jdata, task, data = fixture_data()
    init = jax.tree_util.tree_map(np.asarray, jax_make_model(
        jtask, width=4).init(jax.random.PRNGKey(1)))
    real = modelzoo.make_model
    monkeypatch.setattr(fl_loop, "make_model", lambda *a, **k: dataclasses.
                        replace(real(*a, **k),
                                init=lambda gen: bridge.params_from_numpy(
                                    init)))
    hj = jax_fl.run_federated(jtask, jax_algorithms.make("fedgkd"), jdata,
                              seed=0, width=4, rounds=1,
                              executor=reference_async(buffer_size=2))
    ht = fl_loop.run_federated(task, algorithms.make("fedgkd"), data, seed=0,
                               width=4, rounds=1, device="cpu",
                               executor=port_async(buffer_size=2))
    assert ht.telemetry["round_body"] == "client_batched"
    assert_matches_reference(ht, hj)
    assert max_diff(ht.final_params, hj.final_params) < TOL
