"""Multi-host placement and the shard_map executor in the port, against the
JAX reference on the CPU.

What is held here (the reference's ``tests/test_multihost.py`` contract):

  * ownership ``host(cid) = shard_of(cid) % n_hosts`` partitions the
    population, each host keeps ``warm_cap // n_hosts``, and the slab store
    refuses an unowned client;
  * the filesystem allgather (an ``.npz`` with a JSON spec; the
    reference's spec is msgpack) round-trips every payload, its own too,
    times out naming the missing hosts and the tag, and degrades for
    ``allgather_partial``; the coordinated resume's barriers agree, refuse
    and retire as the reference's;
  * ``n_hosts == 1`` is inert: bit for bit the run without placement, on
    every executor, with faults and checkpoints;
  * two worker processes over one exchange directory, from the
    reference's init: their params, accuracies and gathered telemetry
    agree bitwise (``peak_warm`` is the one per-host value) and equal the
    reference's single-host run within 1e-5 (FedAvg, FedGKD, async, sync
    faults); under host faults the fault counters equal those of the
    reference's two hosts on the same profile (two threads of the test
    process); stopping one host dead and resuming both replays the
    uninterrupted run bit for bit (sync and async);
  * ``ShardMapExecutor`` with 2 and 8 slices on the CPU (the device list
    repeated) equals the reference's ``executor="shard_map"`` run within
    1e-5.  The reference's shard_map route raises a ``ShardingTypeError``
    under this jax when it has more than one device (its own
    ``test_shard_map_multidevice_subprocess_smoke`` fails so), so its run
    here is the one-device one, which is its vmap computation;
  * ``launch/distributed.py``: two gloo ranks stitch a global array and
    run one placed FedAvg round with the same params on both.

The port's two worker processes (every two-host run, one after another)
and the two ``launch.distributed`` ranks start when the module's first
test asks for them and run while the in-process tests do.
"""
import dataclasses
import functools
import json
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from repro import population as jax_pop  # noqa: E402
from repro.configs.paper import TOY as JAX_TOY  # noqa: E402
from repro.core import algorithms as jax_algorithms  # noqa: E402
from repro.core import executor as jax_ex  # noqa: E402
from repro.core import fl_loop as jax_fl  # noqa: E402
from repro.core import systemsim as jax_sim  # noqa: E402
from repro.core.modelzoo import make_model as jax_make_model  # noqa: E402
from repro.data.pipeline import ClientSlabStore as JaxSlabStore  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.paper import CIFAR10, TOY, scaled  # noqa: E402
from repro_torch.core import algorithms, executor, fl_loop, modelzoo  # noqa: E402
from repro_torch.core.systemsim import (FaultInjector, FaultProfile,  # noqa: E402
                                        derive_fault_rng)
from repro_torch.data.pipeline import ClientData, ClientSlabStore  # noqa: E402
from repro_torch.population import (DiskShardSource, HostPlacement,  # noqa: E402
                                    InMemorySource, Population,
                                    SyntheticClientSource, allgather,
                                    allgather_partial, clear_host_payloads,
                                    confirm_resume, resume_barrier,
                                    write_population_shards)
from repro_torch.population.placement import publish  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from test_multihost import _reference_history  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TOL = 1e-5
# the two-process runs' fixture is the reference's: TOY over a synthetic
# population of 50 clients in shards of 4 (5-9 rows), C=0.2 (K=10), warm
# cap 32, width 4
TASK = dict(n_clients=50, participation=0.2, local_epochs=1, batch_size=8)
POP = dict(warm_cap=32, shard_size=4, min_n=5, max_n=9)
HOST_FAULTS = {"crash_prob": 0.1, "corrupt_prob": 0.1, "host_crash_prob": 0.2}
ASYNC_HOST_FAULTS = {"crash_prob": 0.1, "corrupt_prob": 0.1,
                     "timeout_prob": 0.05, "host_crash_prob": 0.3}
FAULT_KEYS = ("host_crashes", "host_timeouts", "crashes", "corrupt_injected",
              "retries", "dropped_clients", "quorum_shortfalls")


def task_of(rounds=2):
    return dataclasses.replace(TOY, rounds=rounds, **TASK)


# ---------------------------------------------------------------------------
# the port's worker: one process of a multi-host run
# ---------------------------------------------------------------------------

_PORT_WORKER = """\
import dataclasses, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
host, n_hosts, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
runs = json.loads(sys.argv[4])
from repro_torch import bridge
from repro_torch.configs.paper import TOY
from repro_torch.core import algorithms, executor, fl_loop, modelzoo
from repro_torch.core.systemsim import FaultProfile
from repro_torch.population import HostPlacement, Population
from repro_torch.tree import tree_leaves

class Dead(Exception):
    # out of the dying host's round callback: its run stops dead, with no
    # cleanup and no goodbye to its peers; the process goes on to its next
    # run
    pass


init = {}
with np.load(os.path.join(root, "init.npz")) as z:
    for key in z.files:
        node = init
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = z[key]
real = modelzoo.make_model
fl_loop.make_model = lambda *a, **k: dataclasses.replace(
    real(*a, **k), init=lambda gen: bridge.params_from_numpy(init))

for cfg in runs:
    if host not in cfg.get("hosts", range(n_hosts)):
        continue
    timeout_s = cfg.get("timeout_s", 120)
    if isinstance(timeout_s, list):             # a deadline for each host
        timeout_s = timeout_s[host]
    pl = HostPlacement(host, n_hosts, exchange_dir=os.path.join(
        root, "exchange", cfg.get("exch", cfg["name"])), timeout_s=timeout_s)
    pop = Population.synthetic(50, placement=pl, **POP)
    task = dataclasses.replace(TOY, rounds=cfg.get("rounds", 2), **TASK)
    kw = {}
    if cfg.get("faults"):
        kw["faults"] = FaultProfile(**cfg["faults"])
    if cfg.get("ckpt"):
        kw["checkpoint_dir"] = os.path.join(root, "ck", cfg["ckpt"])
        kw["resume"] = bool(cfg.get("resume"))
    if cfg.get("die_at_round") is not None and host == cfg["die_host"]:
        # dead right after that round's checkpoint was cut
        def die(rnd, *_, at=cfg["die_at_round"]):
            if rnd == at:
                raise Dead
        kw["round_callback"] = die
    spec = cfg["spec"]
    if spec == "shard_map":
        spec = executor.ShardMapExecutor(strict=True, devices=["cpu"] * 2)
    try:
        h = fl_loop.run_federated(task, algorithms.make(cfg["algo"]),
                                  population=pop, seed=0, executor=spec,
                                  width=4, device="cpu", **kw)
    except Dead:
        continue
    stats = h.telemetry["population"]
    flat = {f"p{i:03d}": t.numpy()
            for i, t in enumerate(tree_leaves(h.final_params))}
    flat["acc"] = np.float64(h.final_acc)
    flat["peak_warm"] = np.int64(stats["peak_warm"])
    flat["warm_cap"] = np.int64(stats["warm_cap"])
    flat["n_host_stats"] = np.int64(len(stats.get("hosts") or []))
    flat["accs"] = np.asarray([r.test_acc for r in h.records], np.float64)
    flat["losses"] = np.asarray([r.mean_local_loss for r in h.records],
                                np.float64)
    flat["sampled"] = np.asarray(
        [c for r in h.records for c in (*(r.sampled or ()), -1)], np.int64)
    ft = h.telemetry.get("faults") or {}
    for key in FAULT_KEYS:
        flat["f_" + key] = np.int64(ft.get(key, -1))
    out = os.path.join(root, "out", f"{cfg['name']}_host{host}.npz")
    with open(out + ".tmp", "wb") as f:     # visible only when complete
        np.savez(f, **flat)
    os.replace(out + ".tmp", out)
"""


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


class Group:
    """Worker processes started together; ``wait()`` checks their exit
    codes (``expect_rc``: host -> code, default 0)."""

    def __init__(self, cmds: dict, expect_rc=None):
        self.expect_rc = expect_rc or {}
        self.procs = {h: subprocess.Popen(
            cmd, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for h, cmd in cmds.items()}
        self.logs = None

    def done(self) -> bool:
        return all(p.poll() is not None for p in self.procs.values())

    def wait(self, timeout=600) -> dict:
        if self.logs is None:
            self.logs = {}
            for h, p in self.procs.items():
                self.logs[h], _ = p.communicate(timeout=timeout)
        for h, p in self.procs.items():
            want = self.expect_rc.get(h, 0)
            assert p.returncode == want, (
                f"worker {h} exited {p.returncode} (wanted {want}):\n"
                f"{self.logs[h][-4000:]}")
        return self.logs

    def kill(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


class Spawned:
    """Every multi-process run of this module, started at once: two pairs
    of port hosts, each running its configurations one after another
    (``RUNS``: the two-round runs and a host left alone; ``FULL``: the
    four-round runs under host faults, then two runs in which host 1 stops
    dead after round 2 while host 0 runs on), and the ``launch.distributed``
    ranks; the resume runs start once ``FULL`` has ended."""

    # checkpointed as the kills are: the async loop's last round refills
    # only with checkpoints on, which draws faults
    SYNC_FULL = {"name": "sync_full", "algo": "fedavg", "spec": "vmap",
                 "rounds": 4, "faults": HOST_FAULTS, "ckpt": "sync_full"}
    ASYNC_FULL = {"name": "async_full", "algo": "fedavg", "spec": "async",
                  "rounds": 4, "faults": ASYNC_HOST_FAULTS,
                  "ckpt": "async_full"}
    # the kills: the survivor waits 15 s for the dead host once; the host
    # that stops waits long for the survivor's slower start of the next run
    KILLS = [dict(cfg, name=f"kill_{kind}", ckpt=f"kill_{kind}",
                  die_at_round=2, die_host=1, timeout_s=[8, 120])
             for kind, cfg in (("sync", SYNC_FULL), ("async", ASYNC_FULL))]
    RUNS = [
        {"name": "fedavg", "algo": "fedavg", "spec": "vmap"},
        {"name": "fedgkd", "algo": "fedgkd", "spec": "vmap"},
        {"name": "async", "algo": "fedavg", "spec": "async"},
        {"name": "faults", "algo": "fedavg", "spec": "vmap",
         "faults": {"crash_prob": 0.2, "corrupt_prob": 0.2}},
        {"name": "shard_map", "algo": "fedavg", "spec": "shard_map"},
        {"name": "alone", "algo": "fedavg", "spec": "vmap", "hosts": [0],
         "timeout_s": 3, "faults": {"crash_prob": 0.05}}]
    FULL = [SYNC_FULL, ASYNC_FULL, *KILLS]

    def __init__(self, root):
        self.root = str(root)
        for sub in ("out", "exchange", "ck"):
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)
        jtask = dataclasses.replace(JAX_TOY, rounds=2, **TASK)
        init = jax_make_model(jtask, width=4).init(jax.random.PRNGKey(1))
        np.savez(os.path.join(self.root, "init.npz"), **{
            "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(init)[0]})
        self.worker = os.path.join(self.root, "worker.py")
        with open(self.worker, "w") as f:
            f.write(f"TASK = {TASK!r}\nPOP = {POP!r}\n"
                    f"FAULT_KEYS = {FAULT_KEYS!r}\n" + _PORT_WORKER)
        self.killed_ckpts: dict = {}
        self.groups = {"runs": self.port(self.RUNS),
                       "full": self.port(self.FULL)}
        from repro_torch.launch.distributed import find_free_port
        coord = f"127.0.0.1:{find_free_port()}"
        self.groups["distributed"] = Group({r: [
            sys.executable, "-m", "repro_torch.launch.distributed",
            "--coordinator", coord, "--num-processes", "2", "--process-id",
            str(r), "--device", "cpu", "--exchange-dir",
            os.path.join(self.root, "exchange", "distributed")]
            for r in range(2)})

    def port(self, runs) -> Group:
        return Group({h: [sys.executable, self.worker, str(h), "2", self.root,
                          json.dumps(runs)] for h in range(2)})

    def out(self, name, hosts=(0, 1), group=None) -> list[dict]:
        """The hosts' outputs of run ``name``, as soon as they are written
        (a group whose processes end without them fails here)."""
        if group is None:
            group = ("runs" if any(c["name"] == name for c in self.RUNS)
                     else "full")
        paths = [os.path.join(self.root, "out", f"{name}_host{h}.npz")
                 for h in hosts]
        deadline = time.monotonic() + 600
        while not all(map(os.path.exists, paths)):
            if self.groups[group].done():
                self.groups[group].wait()
                assert all(map(os.path.exists, paths)), f"no output {name}"
            assert time.monotonic() < deadline, f"no output {name}"
            time.sleep(0.05)
        outs = []
        for path in paths:
            with np.load(path) as z:
                outs.append({k: z[k] for k in z.files})
        return outs

    def resumed(self, kind):
        """After the kills, both hosts restarted with ``resume=True`` over
        each kill's checkpoints and exchange directory."""
        if "resume" not in self.groups:
            self.groups["full"].wait()
            for k in ("sync", "async"):
                # the checkpoints the kill left, before the resume adds any
                self.killed_ckpts[k] = sorted(os.listdir(
                    os.path.join(self.root, "ck", f"kill_{k}")))
            self.groups["resume"] = self.port([
                dict(cfg, name=f"resume_{k}", exch=f"kill_{k}",
                     ckpt=f"kill_{k}", resume=True)
                for k, cfg in (("sync", self.SYNC_FULL),
                               ("async", self.ASYNC_FULL))])
        return self.out(f"resume_{kind}", group="resume")

    def kill_all(self):
        for g in self.groups.values():
            g.kill()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    s = Spawned(tmp_path_factory.mktemp("multihost"))
    yield s
    s.kill_all()


def assert_hosts_identical(h0, h1):
    """Bitwise: the hosts aggregated byte-identical exchange inputs;
    ``peak_warm`` is the one per-host value."""
    assert sorted(h0) == sorted(h1)
    for k in sorted(h0):
        if k != "peak_warm":
            np.testing.assert_array_equal(h0[k], h1[k], err_msg=k)


def param_keys(flat) -> list[str]:
    return sorted(k for k in flat if k[0] == "p" and k[1:].isdigit())


def diff_to(ref_params, flat) -> float:
    keys = param_keys(flat)
    leaves = jax.tree_util.tree_leaves(ref_params)
    assert len(keys) == len(leaves)
    return max(float(np.max(np.abs(np.asarray(x) - flat[k])))
               for k, x in zip(keys, leaves))


def sampled_of(hist) -> np.ndarray:
    return np.asarray([c for r in hist.records
                       for c in (*(r.sampled or ()), -1)], np.int64)


# ---------------------------------------------------------------------------
# HostPlacement: validation, ownership, the split of the warm cap
# ---------------------------------------------------------------------------

def test_placement_validation():
    for cls in (HostPlacement, jax_pop.HostPlacement):
        with pytest.raises(ValueError, match="n_hosts"):
            cls(0, 0)
        with pytest.raises(ValueError, match="out of range"):
            cls(2, 2, exchange_dir="x")
        with pytest.raises(ValueError, match="exchange_dir"):
            cls(0, 2)
        cls(0, 1)


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5])
def test_ownership_partitions_every_shard(n_hosts, spawned):
    """Exactly one owner per shard, the reference's.  (The first test to
    ask for the worker processes: they start here.)"""
    for shard in range(17):
        owners = [HostPlacement(h, n_hosts, exchange_dir="x").owns_shard(shard)
                  for h in range(n_hosts)]
        assert sum(owners) == 1
        assert owners == [jax_pop.HostPlacement(
            h, n_hosts, exchange_dir="x").owns_shard(shard)
            for h in range(n_hosts)]


def test_split_cap():
    p = HostPlacement(0, 2, exchange_dir="x")
    assert p.split_cap(None) is None
    assert p.split_cap(16) == 8
    assert p.split_cap(1) == 1
    assert HostPlacement(0, 1).split_cap(16) == 16
    for cap in (None, 1, 7, 16):
        assert p.split_cap(cap) == jax_pop.HostPlacement(
            0, 2, exchange_dir="x").split_cap(cap)


def test_population_placement_splits_warm_cap():
    pops = [Population.synthetic(40, warm_cap=16, shard_size=8, min_n=3,
                                 max_n=6, placement=HostPlacement(
                                     h, 2, exchange_dir="x"))
            for h in range(2)]
    ref = jax_pop.Population.synthetic(
        40, warm_cap=16, shard_size=8, min_n=3, max_n=6,
        placement=jax_pop.HostPlacement(1, 2, exchange_dir="x"))
    assert pops[1].store.warm_cap == ref.store.warm_cap == 8
    assert pops[1].multihost and not Population.synthetic(
        40, placement=HostPlacement(0, 1)).multihost
    for cid in range(40):
        assert pops[0].owned(cid) != pops[1].owned(cid)
        assert pops[1].owned(cid) == ref.owned(cid)
    # probing shapes does not warm an unowned client
    pops[1].probe_client()
    assert len(pops[1].store.warm) == 0
    np.testing.assert_array_equal(pops[1].probe_client().x,
                                  ref.probe_client().x)


def test_slab_store_refuses_unowned_clients():
    store = ClientSlabStore(owns=lambda cid: cid % 2 == 0)
    data = ClientData(np.ones((4, 2), np.float32), np.zeros(4, np.int64))
    store.get(2, data, "cpu")
    with pytest.raises(ValueError, match="not owned"):
        store.get(1, data, "cpu")
    store.get(None, data, "cpu")        # uncached reads are not gated


def test_slab_store_moves_and_uncached_reads():
    """A resident client asked for on another device moves there (no host
    upload); ``cid=None`` uploads every time and caches nothing; the
    counters follow the reference's on the CPU part of the sequence."""
    store, ref = ClientSlabStore(), JaxSlabStore()
    data = ClientData(np.arange(12, dtype=np.float32).reshape(6, 2),
                      np.arange(6))
    jdev = jax.devices()[0]
    for _ in range(2):
        store.get(None, data, "cpu")
        ref.get(None, data, jdev)
    store.get(3, data, "cpu")
    ref.get(3, data, jdev)
    assert store.stats() == ref.stats()
    assert store.host_transfers == 3 and list(store.slabs) == [3]
    moved = store.get(3, data, "meta")
    assert moved["x"].device.type == "meta" and store.device_moves == 1
    assert store.host_transfers == 3 and store.hits == 0
    assert store.get(3, data, "meta") is moved and store.hits == 1


# ---------------------------------------------------------------------------
# the filesystem allgather, the coordinated resume's barriers
# ---------------------------------------------------------------------------

def pair(tmp_path, n=2, **kw):
    return [HostPlacement(h, n, exchange_dir=str(tmp_path), **kw)
            for h in range(n)]


def test_allgather_roundtrip(tmp_path):
    p0, p1 = pair(tmp_path, timeout_s=10)
    mine = {"idx": [0, 2], "uploads": [torch.arange(6, dtype=torch.float32),
                                      np.eye(2)],
            "weights": [1.5, 2.0], "stats": {"peak_warm": 3, "rss": 0.1}}
    theirs = {"idx": [1], "uploads": [{"params": {"w": torch.full((3,), 7.)}}],
              "weights": [0.5], "stats": {"peak_warm": 2}}
    publish(p1, "round000000", theirs)
    got = allgather(p0, "round000000", mine)
    assert len(got) == 2
    # this host's payload round-trips through its own file too
    assert torch.equal(got[0]["uploads"][0], mine["uploads"][0])
    assert got[0]["uploads"][0].dtype == torch.float32
    np.testing.assert_array_equal(got[0]["uploads"][1], np.eye(2))
    assert got[0]["idx"] == [0, 2] and got[0]["weights"] == [1.5, 2.0]
    assert got[0]["stats"] == mine["stats"]
    assert torch.equal(got[1]["uploads"][0]["params"]["w"],
                       torch.full((3,), 7.))
    assert p0.stats["exchanges"] == 1 and p0.stats["publish_ms"] > 0


def test_allgather_times_out_naming_missing_hosts_and_tag(tmp_path):
    p0 = HostPlacement(0, 3, exchange_dir=str(tmp_path), timeout_s=0.2)
    with pytest.raises(RuntimeError,
                       match=r"'round000001'.*host\(s\) \[1, 2\]"):
        allgather(p0, "round000001", {"idx": []})
    assert p0.stats["timeouts"] == 1
    assert p0.stats["last_missing"] == [1, 2]
    assert p0.stats["last_missing_tag"] == "round000001"


def test_allgather_partial_degrades_and_skips_dead_hosts(tmp_path):
    p0 = HostPlacement(0, 2, exchange_dir=str(tmp_path), timeout_s=0.2)
    payloads, missing = allgather_partial(p0, "wave000000000", {"x": 1})
    assert missing == (1,)
    assert payloads[1] is None and payloads[0]["x"] == 1
    # a peer already declared dead costs one existence check, no time-out
    p1 = HostPlacement(0, 2, exchange_dir=str(tmp_path), timeout_s=60)
    t0 = time.monotonic()
    payloads, missing = allgather_partial(p1, "wave000000001", {"x": 2},
                                          skip_wait={1})
    assert missing == (1,) and payloads[0]["x"] == 2
    assert time.monotonic() - t0 < 10


def test_resume_barrier_agrees_on_min_round(tmp_path):
    p0, p1 = pair(tmp_path, timeout_s=10)
    publish(p1, "resume-avail", {"avail": 7})
    assert resume_barrier(p0, 3) == 3
    assert resume_barrier(p1, 7) == 3


def test_resume_barrier_all_fresh_and_mixed(tmp_path):
    p0, p1 = pair(tmp_path / "fresh", timeout_s=10)
    publish(p1, "resume-avail", {"avail": None})
    assert resume_barrier(p0, None) is None
    p0, p1 = pair(tmp_path / "mixed", timeout_s=10)
    publish(p1, "resume-avail", {"avail": None})
    with pytest.raises(RuntimeError, match="mixed fresh/resume"):
        resume_barrier(p0, 4)


def test_confirm_resume_validates_and_retires_phase1(tmp_path):
    p0, p1 = pair(tmp_path, timeout_s=10)
    publish(p0, "resume-avail", {"avail": 3})
    meta = {"round": 3, "version": 9, "algo": "fedavg"}
    publish(p1, "resume-ok-r000003", dict(meta))
    confirm_resume(p0, 3, meta)
    assert not os.path.exists(str(tmp_path / "resume-avail_host000.npz"))
    publish(p1, "resume-ok-r000004", {"round": 4, "version": 9,
                                      "algo": "fedavg"})
    with pytest.raises(RuntimeError, match="diverged"):
        confirm_resume(p0, 4, {"round": 4, "version": 11, "algo": "fedavg"})


def test_clear_host_payloads_removes_own_wave_files_only(tmp_path):
    p0, p1 = pair(tmp_path, timeout_s=10)
    publish(p0, "wave000000004", {"x": 1})
    publish(p0, "round000002a01", {"x": 2})
    publish(p0, "resume-avail", {"avail": 2})
    publish(p1, "wave000000004", {"x": 3})
    assert clear_host_payloads(p0) == 2
    assert sorted(os.listdir(tmp_path)) == ["resume-avail_host000.npz",
                                            "wave000000004_host001.npz"]


def test_sources_max_client_n_and_shard_opens_match_the_reference(tmp_path):
    """``max_client_n`` of the three sources and the population, and the
    disk source's cold opens, as the reference's (no client drawn for the
    synthetic bound)."""
    syn = SyntheticClientSource(30, seed=0, shard_size=8, min_n=3, max_n=11)
    jsyn = jax_pop.SyntheticClientSource(30, seed=0, shard_size=8, min_n=3,
                                         max_n=11)
    assert syn.max_client_n() == jsyn.max_client_n() == 11
    clients = [syn.client(c) for c in range(30)]
    mem = InMemorySource(clients, n_shards=3)
    assert mem.max_client_n() == max(c.n for c in clients)
    write_population_shards(str(tmp_path / "port"), iter(clients),
                            shard_size=8)
    jax_pop.write_population_shards(str(tmp_path / "ref"), iter(clients),
                                    shard_size=8)
    disk = DiskShardSource(str(tmp_path / "port"), max_open=2)
    jdisk = jax_pop.DiskShardSource(str(tmp_path / "ref"), max_open=2)
    assert disk.max_client_n() == jdisk.max_client_n() == mem.max_client_n()
    assert disk.shard_opens == jdisk.shard_opens == 4
    disk.client(29), jdisk.client(29)
    assert disk.shard_opens == jdisk.shard_opens
    pop = Population(disk, clients[0].x, clients[0].y)
    assert pop.max_client_n() == mem.max_client_n()


def test_draw_host_crashes_matches_the_reference():
    for p in (0.2, 0.7):
        port = FaultInjector(FaultProfile(crash_prob=0.1, host_crash_prob=p),
                             derive_fault_rng(3))
        ref = jax_sim.FaultInjector(
            jax_sim.FaultProfile(crash_prob=0.1, host_crash_prob=p),
            jax_sim.derive_fault_rng(3))
        for _ in range(20):
            assert port.draw_host_crashes(3) == ref.draw_host_crashes(3)
            assert port.draw() == ref.draw()
        assert port.counters == ref.counters
    with pytest.raises(AssertionError, match="shift the fault stream"):
        FaultInjector(FaultProfile()).draw_host_crashes(2)


# ---------------------------------------------------------------------------
# n_hosts == 1 is inert
# ---------------------------------------------------------------------------

def tiny_task():
    return dataclasses.replace(TOY, n_clients=12, participation=0.25,
                               rounds=2, local_epochs=1, batch_size=8)


def tiny_pop(placement=None):
    return Population.synthetic(12, warm_cap=8, shard_size=4, min_n=5,
                                max_n=9, placement=placement)


def assert_bitwise(h0, h1):
    for r0, r1 in zip(h0.records, h1.records, strict=True):
        assert r0.sampled == r1.sampled
        assert r0.mean_local_loss == r1.mean_local_loss
    for a, b in zip(tree_leaves(h0.final_params),
                    tree_leaves(h1.final_params), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["fedavg", "fedgkd"])
@pytest.mark.parametrize("spec", ["sequential", "vmap", "async", "shard_map"])
def test_n_hosts_1_bit_identical(name, spec):
    def run(placement):
        ex = (executor.ShardMapExecutor(devices=["cpu"] * 2)
              if spec == "shard_map" else spec)
        return fl_loop.run_federated(tiny_task(), algorithms.make(name),
                                     population=tiny_pop(placement), seed=0,
                                     executor=ex, width=4, device="cpu")

    assert_bitwise(run(None), run(HostPlacement(0, 1)))


def test_n_hosts_1_inert_with_faults_and_checkpoint(tmp_path):
    """``host_crash_prob`` draws only under placement over several hosts:
    one host replays the one-host fault stream and writes the same
    ``state_`` checkpoints."""
    kw = dict(seed=0, executor="async", width=4, device="cpu",
              faults=FaultProfile(crash_prob=0.2, corrupt_prob=0.2,
                                  host_crash_prob=0.5))
    h0 = fl_loop.run_federated(tiny_task(), algorithms.make("fedavg"),
                               population=tiny_pop(),
                               checkpoint_dir=str(tmp_path / "a"), **kw)
    h1 = fl_loop.run_federated(tiny_task(), algorithms.make("fedavg"),
                               population=tiny_pop(HostPlacement(0, 1)),
                               checkpoint_dir=str(tmp_path / "b"), **kw)
    assert_bitwise(h0, h1)
    assert h1.telemetry["faults"]["host_crashes"] == 0
    assert sorted(os.listdir(tmp_path / "a")) == sorted(
        os.listdir(tmp_path / "b"))
    assert any(f.startswith("state_0") for f in os.listdir(tmp_path / "b"))


def test_available_executors_equal_the_reference():
    assert executor.available() == jax_ex.available()


# ---------------------------------------------------------------------------
# the shard_map executor in one process
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference(algo, spec, faults=()):
    """The reference's single-host run on the two-process fixture
    (``faults``: a ``FaultProfile``'s items), once per module."""
    kw = {"faults": jax_sim.FaultProfile(**dict(faults))} if faults else {}
    return _reference_history(algo, spec, **kw)


def with_reference_init(monkeypatch):
    jtask = dataclasses.replace(JAX_TOY, rounds=2, **TASK)
    init = jax.tree_util.tree_map(np.asarray, jax_make_model(
        jtask, width=4).init(jax.random.PRNGKey(1)))
    real = modelzoo.make_model
    monkeypatch.setattr(fl_loop, "make_model", lambda *a, **k: (
        dataclasses.replace(real(*a, **k),
                            init=lambda gen: bridge.params_from_numpy(init))))


def run_slices(monkeypatch, algo, devices):
    """The port on the fixture from the reference's init, through the
    shard_map executor on ``devices`` (or the vmap executor: None)."""
    with_reference_init(monkeypatch)
    ex = (executor.ShardMapExecutor(strict=True, devices=devices)
          if devices else "vmap")
    return fl_loop.run_federated(
        task_of(), algorithms.make(algo), seed=0, width=4, device="cpu",
        population=Population.synthetic(50, **POP), executor=ex)


def assert_sliced(h, n_slices):
    tele = h.telemetry
    assert (tele["route"], tele["n_devices"], tele["cohort"],
            tele["padded_to"]) == ("shard_map", n_slices, 10,
                                   -(-10 // n_slices) * n_slices)
    assert tele["placement"]["host_transfers"] > 0


@pytest.mark.parametrize("n_slices", [2, 8])
def test_shard_map_slices_match_the_reference(monkeypatch, n_slices):
    """FedGKD (the teacher precompute on each slice), K=10 over 2 slices
    of 5 and over 8 slices of 2 with 6 phantom clients: within 1e-5 of the
    reference's ``executor="shard_map"`` run, with its cohorts."""
    h = run_slices(monkeypatch, "fedgkd", ["cpu"] * n_slices)
    assert_sliced(h, n_slices)
    ref = reference("fedgkd", "shard_map")
    np.testing.assert_array_equal(sampled_of(h), sampled_of(ref))
    port = {f"p{i:03d}": t.numpy()
            for i, t in enumerate(tree_leaves(h.final_params))}
    assert diff_to(ref.final_params, port) < TOL
    for rp, rr in zip(h.records, ref.records, strict=True):
        assert abs(rp.mean_local_loss - rr.mean_local_loss) < TOL


@pytest.mark.parametrize("algo", ["fedgkd-vote", "moon"])
@pytest.mark.parametrize("n_slices", [2, 8])
def test_shard_map_slices_match_the_vmap_executor(monkeypatch, algo,
                                                  n_slices):
    """The part cache on the slices (FedGKD-VOTE) and the vmapped body
    with MOON's client hooks, at 2 and 8 slices: within 1e-5 of the
    port's vmap executor (which the vmap-body and baseline tests hold to
    the reference), with its cohorts."""
    h = run_slices(monkeypatch, algo, ["cpu"] * n_slices)
    assert_sliced(h, n_slices)
    hv = run_slices(monkeypatch, algo, None)
    assert [r.sampled for r in h.records] == [r.sampled for r in hv.records]
    d = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(h.final_params), tree_leaves(hv.final_params),
        strict=True))
    assert d < TOL


def test_shard_map_client_batched_resnet8_equals_vmap():
    """ResNet-8 FedGKD on the client-batched body, K=3 over 2 slices (one
    phantom client): the vmap executor's round within 1e-5; the slabs stay
    resident (the second round uploads only new clients)."""
    task = dataclasses.replace(scaled(CIFAR10, 0.01, rounds=2,
                                      local_epochs=1),
                               image_hw=16, n_clients=6, participation=0.5)
    data = fl_loop.make_federated_data(task, alpha=0.5, seed=0, n_test=32)
    kw = dict(seed=0, width=4, device="cpu", max_batches_per_client=2)
    hv = fl_loop.run_federated(task, algorithms.make("fedgkd"), data,
                               executor="vmap", **kw)
    hs = fl_loop.run_federated(
        task, algorithms.make("fedgkd"), data,
        executor=executor.ShardMapExecutor(devices=["cpu", "cpu"]), **kw)
    assert hs.telemetry["round_body"] == "client_batched"
    assert hs.telemetry["padded_to"] == 4
    d = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(hv.final_params), tree_leaves(hs.final_params),
        strict=True))
    assert d < TOL
    slab = hs.telemetry["placement"]
    cohorts = {c for r in hs.records for c in r.sampled}
    assert slab["host_transfers"] == len(cohorts)
    assert slab["hits"] == 2 * 3 - len(cohorts)


def test_shard_map_one_device_strict_raises_and_falls_back(caplog):
    with pytest.raises(RuntimeError, match="one device"):
        fl_loop.run_federated(tiny_task(), algorithms.make("fedavg"),
                              population=tiny_pop(), width=4, device="cpu",
                              executor=executor.ShardMapExecutor(strict=True))
    with caplog.at_level(logging.WARNING):
        h = fl_loop.run_federated(tiny_task(), algorithms.make("fedavg"),
                                  population=tiny_pop(), width=4,
                                  device="cpu", executor="shard_map")
    assert h.telemetry["route"] == "vmap-fallback"
    assert "degrading to the vmap computation" in caplog.text
    hv = fl_loop.run_federated(tiny_task(), algorithms.make("fedavg"),
                               population=tiny_pop(), width=4, device="cpu",
                               executor="vmap")
    assert_bitwise(h, hv)


def test_multihost_rejects_dp(tmp_path):
    from repro_torch.core.privacy import DPConfig
    pop = tiny_pop(HostPlacement(0, 2, exchange_dir=str(tmp_path),
                                 timeout_s=1))
    with pytest.raises(NotImplementedError, match="dp"):
        fl_loop.run_federated(tiny_task(), algorithms.make("fedavg"),
                              population=pop, width=4, device="cpu",
                              executor="vmap", dp=DPConfig())


# ---------------------------------------------------------------------------
# two worker processes over one exchange directory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["fedavg", "fedgkd"])
def test_two_process_run_matches_single_host(spawned, algo):
    """Each host owns half the shards; both hold the same global, bitwise,
    the telemetry of both, a warm tier within half the cap, and the
    reference's single-host run within 1e-5."""
    h0, h1 = spawned.out(algo)
    assert_hosts_identical(h0, h1)
    assert int(h0["n_host_stats"]) == 2
    for flat in (h0, h1):
        assert int(flat["warm_cap"]) == 16 and int(flat["peak_warm"]) <= 16
    # FedGKD's: the reference's shard_map-executor run, which on one device
    # is its vmap round (the shard_map tests use it too)
    ref = reference(algo, "shard_map" if algo == "fedgkd" else "vmap")
    assert diff_to(ref.final_params, h0) < TOL
    np.testing.assert_array_equal(h0["sampled"], sampled_of(ref))


def test_two_process_async_matches_single_host(spawned):
    """Per-wave exchange tags; both hosts replay the simulation (clock,
    versions, buffers) and equal the reference's single-host async run."""
    h0, h1 = spawned.out("async")
    assert_hosts_identical(h0, h1)
    assert int(h0["n_host_stats"]) == 2
    assert int(h0["peak_warm"]) <= 16 and int(h1["peak_warm"]) <= 16
    ref = reference("fedavg", "async")
    assert diff_to(ref.final_params, h0) < TOL
    np.testing.assert_array_equal(h0["sampled"], sampled_of(ref))


def test_two_process_sync_faults_match_single_host(spawned):
    """Client faults without host faults: the placed fault round draws the
    faults and picks as the one-host round, so the survivors, retries and
    aggregate are the reference's."""
    h0, h1 = spawned.out("faults")
    assert_hosts_identical(h0, h1)
    ref = reference("fedavg", "vmap", (("corrupt_prob", 0.2),
                                       ("crash_prob", 0.2)))
    assert diff_to(ref.final_params, h0) < TOL
    for key in ("crashes", "retries", "corrupt_injected", "host_crashes"):
        assert int(h0["f_" + key]) == ref.telemetry["faults"][key], key


def reference_hosts(exchange_dir: str) -> list:
    """The reference's sync round under ``HOST_FAULTS`` for 4 rounds over
    two hosts: two threads of this process, each a host with its own
    placement over ``exchange_dir`` (the reference's multi-host loop, a
    thread in place of its worker process)."""
    hists, errors = [None, None], []

    def host(h):
        try:
            pop = jax_pop.Population.synthetic(
                50, placement=jax_pop.HostPlacement(
                    h, 2, exchange_dir=exchange_dir, timeout_s=300), **POP)
            hists[h] = jax_fl.run_federated(
                dataclasses.replace(JAX_TOY, rounds=4, **TASK),
                jax_algorithms.make("fedavg"), population=pop, seed=0,
                executor="vmap", width=4,
                faults=jax_sim.FaultProfile(**HOST_FAULTS))
        except Exception as e:          # raised again in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=host, args=(h,)) for h in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return hists


def test_two_process_host_faults_match_the_reference_hosts(spawned,
                                                           tmp_path):
    """Host crashes on the sync round: the two port hosts agree bitwise,
    and their fault counters, cohorts and params are those of the
    reference's two hosts on the same profile (params within 1e-5)."""
    h0, h1 = spawned.out("sync_full")
    assert_hosts_identical(h0, h1)
    j0, j1 = reference_hosts(str(tmp_path))
    assert j0.telemetry["faults"] == j1.telemetry["faults"]
    assert int(h0["f_host_crashes"]) > 0
    for key in FAULT_KEYS:
        assert int(h0["f_" + key]) == j0.telemetry["faults"][key], key
    np.testing.assert_array_equal(h0["sampled"], sampled_of(j0))
    assert diff_to(j0.final_params, h0) < TOL
    assert diff_to(j0.final_params, {
        f"p{i:03d}": np.asarray(x) for i, x in
        enumerate(jax.tree_util.tree_leaves(j1.final_params))}) == 0.0


def test_two_process_async_host_faults_bit_identical(spawned):
    h0, h1 = spawned.out("async_full")
    assert_hosts_identical(h0, h1)
    assert int(h0["f_host_crashes"]) > 0
    assert int(h0["f_host_timeouts"]) == 0


def test_two_process_shard_map_run(spawned):
    """Placement and the shard_map executor together: each host splits
    its slice of the cohort over two CPU slices."""
    h0, h1 = spawned.out("shard_map")
    assert_hosts_identical(h0, h1)
    assert int(h0["peak_warm"]) <= 16
    assert diff_to(reference("fedavg", "vmap").final_params, h0) < TOL


def test_sync_deadline_miss_degrades_to_host_crash(spawned):
    """Host 1 never starts: with faults on, host 0 treats the missed
    deadline as a crashed peer once and finishes on its own uploads."""
    (h0,) = spawned.out("alone", hosts=(0,))
    assert int(h0["f_host_timeouts"]) == 1
    assert np.isfinite(float(h0["acc"]))


def test_distributed_stitch_and_placed_round(spawned):
    """Two gloo ranks of ``python -m repro_torch.launch.distributed``:
    the stitched array's sum on both, and one FedAvg round placed by the
    ranks with the same params on both."""
    logs = spawned.groups["distributed"].wait()
    for r, out in logs.items():
        assert f"rank {r}/2 local=2 global=4 sum=6.0 want=6.0" in out, out
        sums = [line for line in out.splitlines() if "FedAvg round" in line]
        assert len(sums) == 1, out


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_kill_one_host_then_coordinated_resume_bit_identical(spawned, kind):
    """Host 1 stops dead right after round 2's checkpoint (an exception
    out of its round callback: no cleanup, no goodbye); host 0 sees the
    deadline pass once and runs on alone.  Both restart with
    ``resume=True``: they agree on round 2 (the minimum), host 0's stale
    exchange files are retired, and the replay equals the uninterrupted
    two-host run bit for bit, faults included."""
    o0, o1 = spawned.resumed(kind)
    (k0,) = spawned.out(f"kill_{kind}", hosts=(0,))
    assert int(k0["f_host_timeouts"]) == 1
    killed = spawned.killed_ckpts[kind]
    assert "state_host000_000004.npz" in killed
    assert "state_host001_000002.npz" in killed
    assert "state_host001_000003.npz" not in killed
    assert_hosts_identical(o0, o1)
    (full, _) = spawned.out(f"{kind}_full")
    for k in sorted(full):
        if k != "peak_warm":
            np.testing.assert_array_equal(o0[k], full[k], err_msg=k)
