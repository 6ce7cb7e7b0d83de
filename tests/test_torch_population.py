"""The population tier in the port, against the JAX reference on the CPU.

``repro_torch.population`` is the reference's ``repro.population`` for one
host.  What is held here:

  * the sampler draws the reference's ids from the same generator state
    (the rejection fast path, the two-stage draw, with and without
    exclusion) and, with one shard, the flat ``rng.choice`` sequence;
  * ``SyntheticClientSource`` gives the reference's clients and test
    split byte for byte; ``DiskShardSource`` round-trips (JSON metadata);
  * the warm, state and slab stores keep the reference's counters, pins
    and eviction coherence on the same sequence of operations;
  * ``run_federated(population=)`` with one shard equals the port's own
    ``data=`` run (within 1e-5, identical cohorts; in practice bitwise) on
    both executors and the async loop, and equals the reference's
    population run from the bridged init within 1e-5 with the same
    cohorts and tier counters;
  * the 50-round cohort sequences, sync and async, are the reference's;
  * a million registered clients run with the warm tier bounded;
  * kill and resume with spilling client states is bitwise;
  * every algorithm's state store is mutable exactly where the
    reference's is (SCAFFOLD's identity ``update_client_state``), and a
    snapshot does not move when a state is updated in place afterwards.

The TOY fixture is the reference's ragged one (``test_torch_faults.py``:
six clients of 20-150 rows), at participation 0.5 (K=3).
"""
import dataclasses
import logging
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs.paper import TOY as JAX_TOY  # noqa: E402
from repro.core import algorithms as jax_algorithms  # noqa: E402
from repro.core import executor as jax_ex  # noqa: E402
from repro.core import fl_loop as jax_fl  # noqa: E402
from repro.core.systemsim import SpeedProfile as JaxSpeedProfile  # noqa: E402
from repro.data.pipeline import ClientData as JaxClientData  # noqa: E402
from repro.data.pipeline import ClientSlabStore as JaxSlabStore  # noqa: E402
from repro.data.pipeline import FederatedData as JaxFederatedData  # noqa: E402
from repro.data.synthetic import SyntheticTabularTask  # noqa: E402
from repro import population as jax_pop  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.paper import TOY  # noqa: E402
from repro_torch.core import algorithms, executor, fl_loop, modelzoo  # noqa: E402
from repro_torch.core.systemsim import SpeedProfile  # noqa: E402
from repro_torch.data.pipeline import (ClientData, ClientSlabStore,  # noqa: E402
                                       FederatedData, make_slab, slab_rows)
from repro_torch.population import (DiskShardSource,  # noqa: E402
                                    HierarchicalSampler, HostPlacement,
                                    InMemorySource, Population,
                                    SyntheticClientSource, even_shard_sizes,
                                    peak_rss_mb, shift_positions,
                                    write_population_shards)
from repro_torch.population.store import (ClientStateStore,  # noqa: E402
                                          PopulationStore)
from repro_torch.tree import tree_leaves  # noqa: E402

from test_torch_faults import (assert_histories_identical,  # noqa: E402
                               max_diff, ragged_data, reference_init)
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
CPU = torch.device("cpu")


def tiny():
    """(reference task, reference data, port task, port data): the ragged
    fixture at participation 0.5 (K=3), 3 rounds."""
    jtask, jdata, task, data = ragged_data()
    kw = dict(participation=0.5, rounds=3)
    return (dataclasses.replace(jtask, **kw), jdata,
            dataclasses.replace(task, **kw), data)


def with_reference_init(monkeypatch, seed):
    """The port's ``run_federated`` builds its MLP from the reference's
    init at ``seed`` (through the bridge)."""
    real = modelzoo.make_model
    init = reference_init(seed)

    def make(*args, **kwargs):
        return dataclasses.replace(
            real(*args, **kwargs),
            init=lambda gen: bridge.params_from_numpy(init))

    monkeypatch.setattr(fl_loop, "make_model", make)


def assert_same_run(h0, h1, tol=TOL):
    """Identical cohorts; params, losses and accuracies within ``tol``."""
    assert len(h0.records) == len(h1.records)
    for r0, r1 in zip(h0.records, h1.records):
        assert r0.sampled == r1.sampled
        for f in ("mean_local_loss", "test_acc", "test_loss"):
            assert abs(getattr(r0, f) - getattr(r1, f)) < tol, (r0.round, f)
    d = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(h0.final_params), tree_leaves(h1.final_params),
        strict=True))
    assert d < tol


# ------------------------------------------------------------------ sampling

@pytest.mark.parametrize("n,shard,k,n_exc", [
    (1_000_000, 4096, 64, 0),       # rejection fast path
    (1_000_000, 4096, 64, 64),      # ... with in-flight exclusions
    (10_000, 1024, 64, 0),          # 64 draws of 10k: the fast path's edge
    (5_000, 500, 100, 0),           # two-stage: hypergeometric + offsets
    (5_000, 500, 100, 30),          # two-stage with excluded shards
    (300, 7, 40, 12),               # many small shards, dense cohort
    (40, 40, 40, 0),                # one shard, the whole population
    (50, 50, 10, 5),                # one shard, exclusion: shifted positions
])
def test_sampler_draws_the_reference_ids(n, shard, k, n_exc):
    """Exact: the same ids and the same generator state afterwards, over
    five draws from one stream."""
    sizes = even_shard_sizes(n, shard)
    np.testing.assert_array_equal(sizes, jax_pop.even_shard_sizes(n, shard))
    port, ref = HierarchicalSampler(sizes), jax_pop.HierarchicalSampler(sizes)
    g_port, g_ref = np.random.default_rng(11), np.random.default_rng(11)
    exc = np.random.default_rng(3).choice(n, size=n_exc, replace=False)
    for _ in range(5):
        got = port.sample(g_port, k, exclude=set(exc.tolist()))
        want = ref.sample(g_ref, k, exclude=set(exc.tolist()))
        np.testing.assert_array_equal(got, want)
        assert len(set(got.tolist())) == k
        assert not set(got.tolist()) & set(exc.tolist())
    assert g_port.bit_generator.state == g_ref.bit_generator.state


def test_sampler_one_shard_is_the_flat_choice():
    """One shard: ``rng.choice(n, k)`` for a fresh cohort, the sorted idle
    ids indexed by ``rng.choice(n - |exc|, k)`` for a refill: the port's
    ``FederatedData.sample_cohort`` and the reference's, draw for draw."""
    n, k = 30, 6
    sampler = HierarchicalSampler([n])
    data = FederatedData([ClientData(np.zeros((1, 2)), np.zeros(1))] * n,
                         None, None, None)
    g = [np.random.default_rng(5) for _ in range(3)]
    exc = {3, 17, 29}
    for _ in range(20):
        got = sampler.sample(g[0], k)
        np.testing.assert_array_equal(got, g[1].choice(n, size=k,
                                                       replace=False))
        np.testing.assert_array_equal(got, data.sample_cohort(g[2], k))
    g = [np.random.default_rng(5) for _ in range(2)]
    for _ in range(20):
        np.testing.assert_array_equal(sampler.sample(g[0], k, exclude=exc),
                                      data.sample_cohort(g[1], k, exclude=exc))
    with pytest.raises(ValueError, match="cannot sample"):
        sampler.sample(np.random.default_rng(0), n - 2, exclude=exc)


def test_shift_positions_matches_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        exc = np.unique(rng.choice(200, size=rng.integers(1, 30),
                                   replace=False))
        pos = rng.choice(200 - len(exc), size=10, replace=False)
        want = np.setdiff1d(np.arange(200), exc)[pos]
        np.testing.assert_array_equal(shift_positions(pos, exc), want)
        np.testing.assert_array_equal(shift_positions(pos, exc),
                                      jax_pop.shift_positions(pos, exc))


# ------------------------------------------------------------------ sources

def test_synthetic_source_equals_the_reference():
    """Byte for byte: clients (first, shard edges, last), sizes without
    materializing, the test split, the shard geometry."""
    kw = dict(seed=3, shard_size=64, min_n=5, max_n=20)
    port = SyntheticClientSource(500, **kw)
    ref = jax_pop.SyntheticClientSource(500, **kw)
    np.testing.assert_array_equal(port.shard_sizes, ref.shard_sizes)
    for cid in (0, 7, 63, 64, 255, 499):
        a, b = port.client(cid), ref.client(cid)
        assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        assert port.client_n(cid) == ref.client_n(cid) == a.n
    for p, r in zip(port.test_set(40), ref.test_set(40)):
        np.testing.assert_array_equal(p, r)
    with pytest.raises(ValueError):
        SyntheticClientSource(10, min_n=5, max_n=4)


def test_disk_shard_source_roundtrip(tmp_path):
    """Written and read back: every client, sizes from the offsets, the
    handle LRU bounded, JSON metadata; a missing directory refused."""
    src = SyntheticClientSource(50, seed=1, shard_size=8, min_n=3, max_n=9)
    meta = write_population_shards(
        str(tmp_path), (src.client(i) for i in range(50)), shard_size=16)
    assert meta == {"n_clients": 50, "shard_sizes": [16, 16, 16, 2]}
    with open(tmp_path / "population.meta") as f:
        assert f.read().startswith("{")          # JSON, not msgpack
    disk = DiskShardSource(str(tmp_path), max_open=2)
    for cid in np.random.default_rng(0).choice(50, size=20, replace=False):
        want, got = src.client(int(cid)), disk.client(int(cid))
        np.testing.assert_array_equal(want.x, got.x)
        np.testing.assert_array_equal(want.y, got.y)
        assert disk.client_n(int(cid)) == want.n
    assert len(disk._open) <= 2
    assert [disk.client_n(i) for i in range(50)] == [
        src.client_n(i) for i in range(50)]
    assert len(disk._open) <= 2
    with pytest.raises(FileNotFoundError):
        DiskShardSource(str(tmp_path / "nowhere"))
    with pytest.raises(ValueError, match="empty"):
        write_population_shards(str(tmp_path / "e"), iter([]))


@pytest.mark.parametrize("kind", ["in_memory", "synthetic", "disk"])
def test_sources_reject_out_of_range_client_ids(kind, tmp_path):
    src = SyntheticClientSource(12, seed=0, shard_size=4, min_n=3, max_n=6)
    if kind == "in_memory":
        src = InMemorySource([src.client(i) for i in range(12)])
    elif kind == "disk":
        write_population_shards(str(tmp_path),
                                (src.client(i) for i in range(12)),
                                shard_size=4)
        src = DiskShardSource(str(tmp_path))
    assert src.n_clients == 12
    for bad in (-1, 12, 10_000):
        with pytest.raises(IndexError, match="out of range"):
            src.client(bad)
        with pytest.raises(IndexError, match="out of range"):
            src.client_n(bad)
    assert src.client(11).n == src.client_n(11)


# ------------------------------------------------------------------ stores

def both_stores(warm_cap, n=40, shard=8):
    """A port and a reference ``PopulationStore`` over one synthetic
    population."""
    kw = dict(seed=0, shard_size=shard, min_n=3, max_n=6)
    return (PopulationStore(SyntheticClientSource(n, **kw), warm_cap=warm_cap),
            jax_pop.PopulationStore(jax_pop.SyntheticClientSource(n, **kw),
                                    warm_cap=warm_cap))


def slab_pair(**kw):
    return ClientSlabStore(**kw), JaxSlabStore(**kw)


def slab_stats(store) -> dict:
    """The counters both slab stores keep, ``device_moves`` among them."""
    return store.stats()


def test_population_store_counters_and_pins_match_the_reference():
    """The same gets, size reads, pins and unpins on both stores: the
    same warm set, LRU order and counters after every step."""
    port, ref = both_stores(warm_cap=3)
    script = ([("get", c) for c in range(5)] + [("n", 3), ("get", 2),
              ("pin", [0, 4]), ("n", 30)]
              + [("get", c) for c in range(10, 16)]
              + [("unpin", [0, 4]), ("get", 0), ("get", 1), ("pin", range(6)),
                 ("get", 5), ("get", 3), ("get", 2), ("unpin", range(6)),
                 ("get", 7)])
    for op, arg in script:
        for store in (port, ref):
            if op == "get":
                store.get(arg)
            elif op == "n":
                store.client_n(arg)
            else:
                getattr(store, op)(arg)
        assert list(port.warm) == list(ref.warm), (op, arg)
        assert port.stats() == ref.stats(), (op, arg)
    assert port.peak_warm > 3          # the all-pinned excursion was kept
    # a pinned client survived eviction pressure
    p2, _ = both_stores(warm_cap=3)
    p2.get(0)
    p2.pin([0])
    for c in range(1, 10):
        p2.get(c)
    assert 0 in p2.warm and len(p2.warm) == 3


def test_warm_eviction_drops_hot_slab_and_attach_chains():
    """Tier coherence as the reference's: a warm eviction drops the slab
    (a drop, not a cap eviction), cap evictions reach both the prior
    observer and the population's count, pins made on either side before
    attaching are kept and shared."""
    for make_hot in (lambda: slab_pair(max_resident=8),):
        (port, ref), (hot, jhot) = both_stores(warm_cap=2), make_hot()
        port.attach_hot(hot)
        ref.attach_hot(jhot)
        jdev = jax.devices()[0]
        for cid in range(4):
            hot.get(cid, port.get(cid), CPU)
            jhot.get(cid, ref.get(cid), jdev)
        assert set(hot.slabs) == set(jhot.slabs) == {2, 3}
        assert slab_stats(hot) == slab_stats(jhot)
        assert port.stats() == ref.stats()
        port.pin([2])
        assert 2 in hot.pinned
    seen = []
    port, _ = both_stores(warm_cap=16)
    hot = ClientSlabStore(max_resident=2,
                          on_evict=lambda cid, entry: seen.append(cid))
    hot.pinned.add(0)
    port.pin([5])
    port.attach_hot(hot)
    assert {0, 5} <= port.pinned and hot.pinned is port.pinned
    for cid in range(4):
        hot.get(cid, port.get(cid), CPU)
    assert seen == [1, 2] and port.hot_evictions == 2 and 0 in hot.slabs


def test_slab_store_matches_make_slab_and_the_reference_counters():
    """Slabs are tensors on the device holding ``make_slab``'s bytes; the
    counters (hits, host transfers, drops, cap evictions, the high-water)
    follow the reference's on the same sequence."""
    seen, jseen = [], []
    hot, jhot = (ClientSlabStore(max_resident=2,
                                 on_evict=lambda c, e: seen.append(c)),
                 JaxSlabStore(max_resident=2,
                              on_evict=lambda c, e: jseen.append(c)))
    rng = np.random.default_rng(0)
    datas = {c: ClientData(rng.normal(size=(5 + 40 * c, 3)).astype(np.float32),
                           rng.integers(0, 9, 5 + 40 * c)) for c in range(4)}
    jdev = jax.devices()[0]
    script = [("get", 0), ("get", 1), ("get", 0), ("pin", 0), ("get", 2),
              ("get", 3), ("drop", 3), ("drop", 3), ("get", 3), ("get", 3),
              ("get", 1)]
    for op, cid in script:
        if op == "get":
            data = datas[cid]
            e = hot.get(cid, data, CPU)
            jhot.get(cid, data, jdev)
            x, y = make_slab(data, slab_rows(data.n))
            assert e["rows"] == slab_rows(data.n) and e["rows"] % 64 == 0
            assert e["x"].device == CPU and e["y"].dtype == torch.int32
            np.testing.assert_array_equal(e["x"].numpy(), x)
            np.testing.assert_array_equal(e["y"].numpy(), y)
        elif op == "pin":
            hot.pinned.add(cid)
            jhot.pinned.add(cid)
        else:
            assert hot.drop(cid) == jhot.drop(cid)
        assert slab_stats(hot) == slab_stats(jhot), (op, cid)
    assert seen == jseen and 0 in hot.slabs


def test_state_store_stateless_holds_nothing():
    calls = []
    states = ClientStateStore(lambda cid: calls.append(cid) or (),
                              mutable=False)
    assert states[3] == ()
    states[3] = ("ignored",)
    assert states[3] == () and len(states.warm) == 0 and calls == [3, 3]
    assert states.snapshot() == {"kind": "state_store", "mutable": False}


def test_state_store_spills_reloads_and_pins_as_the_reference(tmp_path):
    """Writes of tensors and of jax arrays through the same sequence with
    a warm cap of 2 and a pin: the same warm order, spill set and
    counters; spilled values come back exactly, on the run's device."""
    def init(cid):
        return {"prev": {"w": torch.zeros(3)}}

    def jinit(cid):
        return {"prev": {"w": jax.numpy.zeros(3)}}

    pinned, jpinned = {0}, {0}
    port = ClientStateStore(init, mutable=True, warm_cap=2,
                            spill_dir=str(tmp_path / "p"), pinned=pinned)
    ref = jax_pop.ClientStateStore(jinit, mutable=True, warm_cap=2,
                                   spill_dir=str(tmp_path / "r"),
                                   pinned=jpinned)
    for cid in range(5):
        port[cid] = {"prev": {"w": torch.full((3,), float(cid))}}
        ref[cid] = {"prev": {"w": jax.numpy.full((3,), float(cid))}}
    for cid in (1, 2, 9, 0, 3):
        got, want = port[cid], ref[cid]
        np.testing.assert_array_equal(got["prev"]["w"].numpy(),
                                      np.asarray(want["prev"]["w"]))
        assert got["prev"]["w"].device == CPU
    assert list(port.warm) == list(ref.warm)
    assert port.spilled == ref.spilled
    assert port.stats() == ref.stats()
    assert os.path.exists(tmp_path / "p" / "state_000000001.npz")
    # an all-pinned storm exceeds the cap, then drains on unpin
    pinned.update(range(10))
    for cid in range(5, 8):
        port[cid] = {"prev": {"w": torch.full((3,), float(cid))}}
    assert len(port.warm) > 2
    spills = port.state_spills
    pinned.clear()
    port[8] = {"prev": {"w": torch.full((3,), 8.0)}}
    assert len(port.warm) == 2 and port.state_spills > spills
    for cid in (5, 6, 7):
        assert float(port[cid]["prev"]["w"][0]) == float(cid)


def test_state_store_corrupt_spill_reinits_with_warning(tmp_path, caplog):
    states = ClientStateStore(lambda cid: {"w": torch.zeros(3)}, mutable=True,
                              warm_cap=1, spill_dir=str(tmp_path))
    states[0] = {"w": torch.full((3,), 5.0)}
    states[1] = {"w": torch.full((3,), 6.0)}        # spills client 0
    with open(tmp_path / "state_000000000.npz", "r+b") as f:
        f.truncate(32)
    with caplog.at_level(logging.WARNING, logger="repro_torch.population"):
        got = states[0]
    assert float(got["w"][0]) == 0.0 and 0 not in states.spilled
    assert states.stats()["state_corrupt_reinits"] == 1
    assert any("corrupt state spill" in r.message for r in caplog.records)
    states[2] = {"w": torch.full((3,), 7.0)}        # a clean spill again
    assert float(states[0]["w"][0]) == 0.0


def test_snapshot_is_unaffected_by_in_place_updates(tmp_path):
    """Tensors are mutable: a state updated in place after the snapshot
    (an optimizer's ``add_``, a container rebound) leaves the snapshot and
    a store restored from it at the snapshot's values."""
    def init(cid):
        return {"prev": {"w": torch.zeros(3)}, "np": np.zeros(2), "step": 0}

    states = ClientStateStore(init, mutable=True, warm_cap=8,
                              spill_dir=str(tmp_path))
    live = {"prev": {"w": torch.full((3,), 5.0)}, "np": np.ones(2), "step": 4}
    states[0] = live
    snap = states.snapshot()
    live["prev"]["w"].add_(94.0)
    live["np"][:] = 7.0
    live["step"] = 5
    live["prev"]["extra"] = torch.ones(1)
    assert float(snap["warm_states"][0]["prev"]["w"][0]) == 5.0
    restored = ClientStateStore(init, mutable=True, warm_cap=8,
                                spill_dir=str(tmp_path))
    restored.restore(snap)
    got = restored[0]
    assert float(got["prev"]["w"][0]) == 5.0 and got["step"] == 4
    assert float(got["np"][0]) == 1.0 and set(got["prev"]) == {"w"}
    assert restored.state_hits == 1
    with pytest.raises(ValueError, match="mutability"):
        ClientStateStore(init, mutable=False).restore(snap)


@pytest.mark.parametrize("name", sorted(algorithms.available()))
def test_state_store_mutability_equals_the_reference(name):
    """Which algorithms get a mutable state store: decided by whether the
    class overrides ``update_client_state``, as the reference decides."""
    params = {"w": torch.zeros(2)}
    port = Population.from_federated(ragged_data()[3]).make_client_states(
        algorithms.make(name), params)
    ref = jax_pop.Population.from_federated(
        ragged_data()[1]).make_client_states(jax_algorithms.make(name),
                                             {"w": np.zeros(2)})
    assert port.mutable == ref.mutable
    assert port.mutable == (name in ("moon", "scaffold", "feddyn"))


def test_placement_and_peak_rss():
    for kw in (dict(host_id=0, n_hosts=1), dict(host_id=1, n_hosts=3,
                                                exchange_dir="d")):
        port, ref = HostPlacement(**kw), jax_pop.HostPlacement(**kw)
        assert (port.host_id, port.n_hosts, port.exchange_dir) == (
            ref.host_id, ref.n_hosts, ref.exchange_dir)
    for bad in (dict(host_id=0, n_hosts=0), dict(host_id=2, n_hosts=2),
                dict(host_id=0, n_hosts=2)):
        with pytest.raises(ValueError):
            HostPlacement(**bad)
        with pytest.raises(ValueError):
            jax_pop.HostPlacement(**bad)
    # several hosts: each keeps its share of the warm cap, as the
    # reference's does
    placed = [(Population.from_federated(ragged_data()[3], n_shards=3,
                                         warm_cap=9, placement=HostPlacement(
                                             h, 2, exchange_dir="d")),
               jax_pop.Population.from_federated(
                   ragged_data()[1], n_shards=3, warm_cap=9,
                   placement=jax_pop.HostPlacement(h, 2, exchange_dir="d")))
              for h in range(2)]
    for port, ref in placed:
        assert port.store.warm_cap == ref.store.warm_cap == 4
        assert port.multihost and ref.multihost
        assert [port.owned(c) for c in range(port.n_clients)] == [
            ref.owned(c) for c in range(ref.n_clients)]
    data = ragged_data()[3]
    pop = Population.from_federated(data, placement=HostPlacement(0, 1))
    assert pop.stats()["n_hosts"] == 1
    assert peak_rss_mb() > 0


# ------------------------------------------------------------------ the loop

def test_run_federated_requires_exactly_one_source():
    _, _, task, data = tiny()
    with pytest.raises(ValueError, match="exactly one"):
        fl_loop.run_federated(task, algorithms.make("fedavg"), device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        fl_loop.run_federated(task, algorithms.make("fedavg"), data,
                              population=Population.from_federated(data),
                              device="cpu")


@pytest.mark.parametrize("name", ["fedavg", "fedgkd", "moon"])
@pytest.mark.parametrize("spec", ["sequential", "vmap"])
def test_population_matches_eager_data(name, spec):
    """One shard: the port's ``data=`` run, within 1e-5 with identical
    cohorts; the telemetry only with ``population=``, every pin released."""
    _, _, task, data = tiny()
    h0 = fl_loop.run_federated(task, algorithms.make(name), data, seed=0,
                               executor=spec, device="cpu")
    h1 = fl_loop.run_federated(task, algorithms.make(name),
                               population=Population.from_federated(data),
                               seed=0, executor=spec, device="cpu")
    assert_same_run(h0, h1)
    assert "population" not in h0.telemetry
    assert h1.telemetry["population"]["pinned"] == 0


@pytest.mark.parametrize("name", ["fedavg", "fedgkd-vote"])
def test_population_matches_eager_data_async(name):
    _, _, task, data = tiny()
    kw = dict(seed=0, rounds=4, device="cpu")
    h0 = fl_loop.run_federated(task, algorithms.make(name), data,
                               executor=executor.AsyncExecutor(
                                   staleness="constant", buffer_size=2), **kw)
    h1 = fl_loop.run_federated(task, algorithms.make(name),
                               population=Population.from_federated(data),
                               executor=executor.AsyncExecutor(
                                   staleness="constant", buffer_size=2), **kw)
    assert_same_run(h0, h1)
    assert h1.telemetry["population"]["pinned"] == 0


def test_population_matches_the_reference_population(monkeypatch):
    """MOON over three shards with a warm cap of 3 (evictions, spills of
    its client states), the port against the reference from the bridged
    init: the same cohorts and tier counters, params within 1e-5."""
    jtask, jdata, task, data = tiny()
    kw = dict(n_shards=3, warm_cap=3, state_warm_cap=2)
    with_reference_init(monkeypatch, 0)
    ht = fl_loop.run_federated(task, algorithms.make("moon"),
                               population=Population.from_federated(data, **kw),
                               seed=0, rounds=4, executor="vmap",
                               device="cpu")
    hj = jax_fl.run_federated(jtask, jax_algorithms.make("moon"),
                              population=jax_pop.Population.from_federated(
                                  jdata, **kw),
                              seed=0, rounds=4, executor="vmap")
    assert [r.sampled for r in ht.records] == [r.sampled for r in hj.records]
    for rt, rj in zip(ht.records, hj.records):
        assert abs(rt.mean_local_loss - rj.mean_local_loss) < TOL
    assert max_diff(ht.final_params, hj.final_params) < TOL
    stats = ht.telemetry["population"]
    assert stats == hj.telemetry["population"]
    assert stats["warm_evictions"] > 0 and stats["state_spills"] > 0
    assert stats["peak_warm"] <= 3


def cohort_fixture(seed_sizes, seed_data, rounds=50):
    """30 clients of 8-29 rows, K=6, in both packages."""
    jtask = dataclasses.replace(JAX_TOY, n_clients=30, participation=0.2,
                                rounds=rounds, local_epochs=1, batch_size=16)
    task = dataclasses.replace(TOY, n_clients=30, participation=0.2,
                               rounds=rounds, local_epochs=1, batch_size=16)
    gen = SyntheticTabularTask(task.num_classes, dim=task.feat_dim, seed=0)
    shards = [gen.generate(int(n), seed=seed_data + i) for i, n in enumerate(
        np.random.default_rng(seed_sizes).integers(8, 30, 30))]
    tx, ty = gen.generate(64, seed=999)
    labels = np.zeros((30, task.num_classes))
    return (jtask, JaxFederatedData([JaxClientData(*s) for s in shards], tx,
                                    ty, labels),
            task, FederatedData([ClientData(*s) for s in shards], tx, ty,
                                labels))


def test_cohort_sequences_50_rounds_equal_the_reference():
    """One shard, 50 synchronous rounds: the port's population run draws
    the reference's cohort sequence."""
    jtask, jdata, task, data = cohort_fixture(5, 200)
    kw = dict(seed=7, max_batches_per_client=1, eval_every=1000, width=4)
    hj = jax_fl.run_federated(jtask, jax_algorithms.make("fedavg"),
                              population=jax_pop.Population.from_federated(
                                  jdata), executor="sequential", **kw)
    ht = fl_loop.run_federated(task, algorithms.make("fedavg"),
                               population=Population.from_federated(data),
                               executor="sequential", device="cpu", **kw)
    assert len(ht.records) == 50
    assert [r.sampled for r in ht.records] == [r.sampled for r in hj.records]


def test_async_cohort_sequences_50_rounds_equal_the_reference():
    """The async loop's refills exclude the in-flight clients: 50
    aggregations draw the reference's buffers, and no pin outlives the
    run."""
    jtask, jdata, task, data = cohort_fixture(6, 300)
    kw = dict(seed=7, max_batches_per_client=1, eval_every=1000, width=4)
    hj = jax_fl.run_federated(
        jtask, jax_algorithms.make("fedavg"),
        population=jax_pop.Population.from_federated(jdata),
        executor=jax_ex.AsyncExecutor(staleness="constant", buffer_size=3,
                                      profile=JaxSpeedProfile(
                                          kind="lognormal")), **kw)
    ht = fl_loop.run_federated(
        task, algorithms.make("fedavg"),
        population=Population.from_federated(data),
        executor=executor.AsyncExecutor(staleness="constant", buffer_size=3,
                                        profile=SpeedProfile(
                                            kind="lognormal")),
        device="cpu", **kw)
    assert len(ht.records) == 50
    assert [r.sampled for r in ht.records] == [r.sampled for r in hj.records]
    assert [r.sim_time for r in ht.records] == [r.sim_time for r in hj.records]
    assert ht.telemetry["population"]["pinned"] == 0


def test_million_client_run_is_warm_cap_bounded():
    """1M registered clients, K=64 cohorts: the warm tier never holds more
    than its cap, and the cold loads are the cohorts and the probe client,
    not O(population)."""
    pop = Population.synthetic(1_000_000, warm_cap=128, shard_size=4096,
                               min_n=8, max_n=24, seed=0, n_test=128)
    task = dataclasses.replace(TOY, n_clients=1_000_000,
                               participation=64 / 1_000_000, rounds=2,
                               local_epochs=1, batch_size=16)
    h = fl_loop.run_federated(task, algorithms.make("fedavg"), population=pop,
                              seed=0, executor="vmap",
                              max_batches_per_client=1, eval_every=1000,
                              width=4, device="cpu")
    stats = h.telemetry["population"]
    assert pop.n_shards == 245
    assert all(len(r.sampled) == 64 for r in h.records)
    assert stats["peak_warm"] <= 128 and len(pop.store.warm) <= 128
    assert stats["cold_loads"] <= 2 * 64 + 1
    assert stats["state_peak_warm"] == 0 and stats["pinned"] == 0


class Killed(Exception):
    pass


def kill_after(rnd):
    def cb(t, *_):
        if t == rnd:
            raise Killed
    return cb


@pytest.mark.parametrize("name,spec", [
    ("feddyn", "sequential"),
    ("moon", executor.AsyncExecutor(staleness="fedgkd", buffer_size=2))])
def test_kill_and_resume_with_spilled_states_is_bitwise(tmp_path, name, spec):
    """A stateful algorithm whose states spill (state warm cap 1), killed
    after round 2 of 4 and resumed from its checkpoint: bit for bit the
    uninterrupted run, the spills reloaded from the directory the
    checkpoint names, and no pin left (async: the restored in-flight
    clients were pinned again)."""
    _, _, task, data = tiny()

    def pop(tag):
        return Population.from_federated(data, n_shards=2, warm_cap=3,
                                         state_warm_cap=1,
                                         state_dir=str(tmp_path / tag))

    kw = dict(seed=0, rounds=4, executor=spec, device="cpu")
    full = fl_loop.run_federated(task, algorithms.make(name),
                                 population=pop("full"), **kw)
    ck = str(tmp_path / "ck")
    with pytest.raises(Killed):
        fl_loop.run_federated(task, algorithms.make(name),
                              population=pop("run"), checkpoint_dir=ck,
                              round_callback=kill_after(2), **kw)
    again = pop("run")
    resumed = fl_loop.run_federated(task, algorithms.make(name),
                                    population=again, checkpoint_dir=ck,
                                    resume=True, **kw)
    assert_histories_identical(full, resumed)
    stats = resumed.telemetry["population"]
    assert stats["state_loads"] > 0 and stats["pinned"] == 0
    assert full.telemetry["population"]["state_spills"] > 0
    # a population checkpoint is refused by a data= run
    with pytest.raises(ValueError, match="population"):
        fl_loop.run_federated(task, algorithms.make(name), data,
                              checkpoint_dir=ck, resume=True, **kw)
