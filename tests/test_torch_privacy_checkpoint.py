"""DP-FedAvg and checkpoint/resume in the port, against the JAX reference
on the CPU.

DP: ``clip_delta`` against the reference's at 1e-6, ``noise_std``, and
``noise_aggregate`` fed the reference's own ``jax.random`` draws through
``DPConfig.noise`` (torch cannot replay ``jax.random``); then 2 FedGKD
rounds on the TOY fixture of ``test_torch_faults.py`` under DP, from the
reference's init and with its draws, to 1e-5.

Checkpoints: the reference's ``checkpoint.io`` cases (round trip with
mixed dtypes and bf16, atomic writes, a torn, a zero-byte and an all-corrupt
directory, non-finite leaves refused), a run state with a ``ModelBuffer``,
and kill-then-resume bit for bit within the port (vmap and sequential, a
torn newest file, the guards, and a subprocess killed with ``os._exit``).
The port's files are JSON where the reference's are msgpack, so no file
crosses between the packages.
"""
import glob
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import algorithms as jax_algorithms  # noqa: E402
from repro.core import privacy as jax_privacy  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import io as ckpt_io  # noqa: E402
from repro_torch.checkpoint import recovery  # noqa: E402
from repro_torch.core import algorithms, privacy  # noqa: E402
from repro_torch.core.server import ModelBuffer  # noqa: E402
from repro_torch.optim import global_norm  # noqa: E402
from repro_torch.tree import tree_flatten, tree_map  # noqa: E402

from test_torch_faults import (CHAOS, assert_histories_identical,  # noqa: E402
                               assert_matches_reference, run_own, run_port,
                               run_reference)

SRC = Path(__file__).resolve().parent.parent / "src"


def reference_draws(dp_seed: int):
    """``DPConfig.noise`` replaying the reference's draws: the key of
    ``(dp_seed, round)`` split into one key a leaf, in flatten order."""
    def noise(round_idx, params):
        leaves = tree_flatten(params)[0]
        rng = jax.random.fold_in(jax.random.PRNGKey(dp_seed), round_idx)
        keys = jax.random.split(rng, len(leaves))
        return [torch.from_numpy(np.array(
                    jax.random.normal(k, tuple(x.shape), jnp.float32)))
                for x, k in zip(leaves, keys)]
    return noise


# -------------------------------------------------------------------- DP

@pytest.mark.parametrize("scale,clip", [(0.05, 1.0), (3.0, 1.0), (10.0, 0.3)])
def test_clip_delta_matches_reference(scale, clip):
    rng = np.random.default_rng(1)
    anchor = {"w": rng.standard_normal((6, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    new = {k: v + scale * rng.standard_normal(v.shape).astype(np.float32)
           for k, v in anchor.items()}
    want = jax_privacy.clip_delta(new, anchor, clip)
    got = privacy.clip_delta(bridge.params_from_numpy(new),
                             bridge.params_from_numpy(anchor), clip)
    for k in anchor:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
    delta = tree_map(lambda a, b: a - b, got, bridge.params_from_numpy(anchor))
    assert float(global_norm(delta)) <= clip * (1 + 1e-5)


def test_noise_std_matches_reference():
    for kw in (dict(), dict(clip_norm=2.0, noise_multiplier=1.3)):
        for n in (0, 1, 4, 7):
            assert (privacy.DPConfig(**kw).noise_std(n)
                    == jax_privacy.DPConfig(**kw).noise_std(n))


def test_noise_aggregate_with_reference_draws():
    rng = np.random.default_rng(2)
    agg = {"fc1": {"w": rng.standard_normal((5, 3)).astype(np.float32),
                   "b": rng.standard_normal(3).astype(np.float32)},
           "fc2": {"w": rng.standard_normal((3, 2)).astype(np.float32)}}
    for t in (0, 3):
        want = jax_privacy.noise_aggregate(
            agg, jax_privacy.DPConfig(seed=5), 4, t)
        got = privacy.noise_aggregate(
            bridge.params_from_numpy(agg),
            privacy.DPConfig(seed=5, noise=reference_draws(5)), 4, t)
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        tree_flatten(got)[0]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)


def test_default_noise_is_seeded_per_round():
    params = {"w": torch.zeros(4000)}
    dp = privacy.DPConfig(noise_multiplier=1.0, clip_norm=2.0)
    a = privacy.noise_aggregate(params, dp, 4, 3)["w"]
    assert torch.equal(a, privacy.noise_aggregate(params, dp, 4, 3)["w"])
    assert not torch.equal(a, privacy.noise_aggregate(params, dp, 4, 4)["w"])
    assert abs(float(a.std()) - dp.noise_std(4)) < 0.05 * dp.noise_std(4)


def test_dp_trajectory_matches_reference(monkeypatch):
    """2 FedGKD rounds under DP (C = 1, σ = 0.5): the clipped deltas and the
    reference's noise give the reference's trajectory to 1e-5."""
    jdp = jax_privacy.DPConfig(clip_norm=1.0, noise_multiplier=0.5, seed=3)
    dp = privacy.DPConfig(clip_norm=1.0, noise_multiplier=0.5, seed=3,
                          noise=reference_draws(3))
    hj = run_reference(jax_algorithms.make("fedgkd", buffer_m=3), seed=0,
                       executor="vmap", dp=jdp)
    ht = run_port(monkeypatch, algorithms.make("fedgkd", buffer_m=3), seed=0,
                  executor="vmap", dp=dp)
    assert_matches_reference(ht, hj)
    free = run_port(monkeypatch, algorithms.make("fedgkd", buffer_m=3),
                    seed=0, executor="vmap")
    assert not torch.equal(tree_flatten(free.final_params)[0][0],
                           tree_flatten(ht.final_params)[0][0])


# ----------------------------------------------------------- checkpoint io

def test_checkpoint_roundtrip_mixed_dtypes(tmp_path):
    tree = {"labels": torch.tensor([0, 3, 9, 2], dtype=torch.int32),
            "model": {"w16": torch.tensor([1.5, -0.25, 3.0],
                                          dtype=torch.float16),
                      "wbf": torch.tensor([1.0, 2.0, -0.5],
                                          dtype=torch.bfloat16),
                      "w32": torch.linspace(0, 1, 5)},
            "count": torch.tensor(7, dtype=torch.int32),
            "host": np.arange(3, dtype=np.int64)}
    path = str(tmp_path / "mixed.npz")
    ckpt_io.save_pytree(path, tree, meta={"round": 3})
    loaded = ckpt_io.load_pytree(path, tree)
    for a, b in zip(tree_flatten(tree)[0], tree_flatten(loaded)[0],
                    strict=True):
        assert type(a) is type(b) and a.dtype == b.dtype
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        assert torch.equal(a, b)
    assert ckpt_io.load_meta(path) == {"round": 3}
    flat = ckpt_io.load_flat(path)
    assert flat["model/wbf"].dtype == torch.bfloat16
    assert sorted(flat) == ["count", "host", "labels", "model/w16",
                            "model/w32", "model/wbf"]


def test_load_latest_round_and_empty(tmp_path):
    for r in (1, 5, 3):
        ckpt_io.save_round(str(tmp_path), r, {"w": torch.full((2,), float(r))})
    loaded, rnd = ckpt_io.load_latest(str(tmp_path), {"w": torch.zeros(2)})
    assert rnd == 5 and torch.equal(loaded["w"], torch.full((2,), 5.0))
    assert ckpt_io.load_latest(str(tmp_path / "nope"), {}) is None


def test_save_pytree_is_atomic(tmp_path):
    """No .tmp debris after a save; a stale .tmp from a crashed writer is
    not a round file."""
    ckpt_io.save_round(str(tmp_path), 1, {"w": torch.ones(2)})
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    with open(tmp_path / "round_000002.npz.tmp", "wb") as f:
        f.write(b"torn mid-write")
    _, rnd = ckpt_io.load_latest(str(tmp_path), {"w": torch.zeros(2)})
    assert rnd == 1


def test_load_latest_skips_torn_and_zero_byte_newest(tmp_path):
    like = {"w": torch.zeros(2)}
    for r in (1, 2, 3):
        ckpt_io.save_round(str(tmp_path), r, {"w": torch.full((2,), float(r))})
    full = tmp_path / "round_000003.npz"
    blob = full.read_bytes()
    full.write_bytes(blob[: len(blob) // 2])            # a torn zip
    loaded, rnd = ckpt_io.load_latest(str(tmp_path), like)
    assert rnd == 2 and torch.equal(loaded["w"], torch.full((2,), 2.0))
    (tmp_path / "round_000009.npz").write_bytes(b"")      # zero bytes
    _, rnd = ckpt_io.load_latest(str(tmp_path), like)
    assert rnd == 2


def test_load_latest_raises_when_all_corrupt(tmp_path):
    for r in (1, 2):
        (tmp_path / f"round_{r:06d}.npz").write_bytes(b"not a zip at all")
    with pytest.raises(RuntimeError, match="partial or corrupt"):
        ckpt_io.load_latest(str(tmp_path), {"w": torch.zeros(2)})


def test_save_pytree_refuses_nonfinite(tmp_path):
    path = str(tmp_path / "bad.npz")
    with pytest.raises(ValueError, match="a/b"):
        ckpt_io.save_pytree(path, {"a": {"b": torch.tensor([float("inf")])}})
    with pytest.raises(ValueError, match="c"):
        ckpt_io.save_pytree(path, {"c": torch.tensor([float("nan")],
                                                     dtype=torch.bfloat16)})
    assert not os.path.exists(path)


def test_run_state_roundtrip_with_model_buffer(tmp_path):
    buf = ModelBuffer(2)
    buf.push({"w": torch.arange(4.0)})
    buf.push({"w": torch.arange(4.0) * 2})
    buf.push({"w": torch.arange(4.0) * 3})      # evicts version 0
    rng = np.random.default_rng(5)
    rng.random(17)              # the 128-bit PCG64 words are nontrivial
    state = {"buffer": buf, "np_rng": recovery.rng_state(rng),
             "records": [{"round": 0, "sampled": (1, 2, 3), "acc": 0.5}],
             "client_states": [(), {"c": torch.ones(2)}], "none": None,
             "host": np.float64(0.1) * 3, 7: [np.int64(2), True]}
    recovery.save_run_state(str(tmp_path), 4, state, meta={"algo": "fedgkd"})
    got, meta, rnd = recovery.load_latest_state(str(tmp_path))
    assert rnd == 4 and meta["algo"] == "fedgkd"
    buf2 = got["buffer"]
    assert buf2.versions == buf.versions == [2, 1]
    assert buf2._next_version == 3
    for a, b in zip(buf2.models, buf.models, strict=True):
        assert torch.equal(a["w"], b["w"])
    assert buf2.push({"w": torch.arange(4.0)}) and buf2.versions == [3, 2]
    assert got["records"][0]["sampled"] == (1, 2, 3)
    assert got["client_states"][0] == ()
    assert torch.equal(got["client_states"][1]["c"], torch.ones(2))
    assert got["host"] == 0.1 * 3 and got[7] == [2, True]
    fresh = np.random.default_rng(0)
    recovery.restore_rng(fresh, got["np_rng"])
    assert fresh.random() == rng.random()
    # an exact round, and no fallback when it is missing
    recovery.save_run_state(str(tmp_path), 6, {"x": 1}, meta={"algo": "a"})
    assert recovery.load_latest_state(str(tmp_path))[2] == 6
    at4, meta4 = recovery.load_state_at(str(tmp_path), 4)
    assert at4["buffer"].versions == [2, 1] and meta4["round"] == 4
    with pytest.raises(FileNotFoundError):
        recovery.load_state_at(str(tmp_path), 5)


def test_round_record_fields_follow_the_reference_and_round_trip():
    """The reference's field order, so ``RoundRecord(**asdict(r))`` (what a
    checkpoint stores) gives ``r`` back."""
    import dataclasses

    from repro.core import fl_loop as jax_fl
    from repro_torch.core import fl_loop

    assert ([f.name for f in dataclasses.fields(fl_loop.RoundRecord)]
            == [f.name for f in dataclasses.fields(jax_fl.RoundRecord)])
    r = fl_loop.RoundRecord(3, 0.5, 1.25, 0.75, 0.1, sim_time=7.5, version=3,
                            mean_staleness=0.5, sampled=(4, 1))
    assert fl_loop.RoundRecord(**dataclasses.asdict(r)) == r


# ----------------------------------------------------------------- resume

@pytest.mark.parametrize("name,spec", [("fedgkd-vote", "vmap"),
                                       ("fedgkd", "sequential")])
def test_resume_reproduces_history_bit_for_bit(tmp_path, name, spec):
    def mk():
        return algorithms.make(name, buffer_m=3)

    full = run_own(mk(), seed=9, rounds=5, executor=spec)
    ck = str(tmp_path / "ck")
    run_own(mk(), seed=9, rounds=3, executor=spec, checkpoint_dir=ck)
    resumed = run_own(mk(), seed=9, rounds=5, executor=spec,
                      checkpoint_dir=ck, resume=True)
    assert_histories_identical(full, resumed)


def test_resume_with_faults_bit_for_bit(tmp_path):
    """The fault stream and counters are checkpointed too: the resumed run
    replays the uninterrupted run's crashes and its telemetry."""
    def mk():
        return algorithms.make("fedgkd", buffer_m=3)

    full = run_own(mk(), seed=12, rounds=4, executor="vmap", faults=CHAOS)
    ck = str(tmp_path / "ck")
    run_own(mk(), seed=12, rounds=2, executor="vmap", faults=CHAOS,
            checkpoint_dir=ck)
    resumed = run_own(mk(), seed=12, rounds=4, executor="vmap", faults=CHAOS,
                      checkpoint_dir=ck, resume=True)
    assert_histories_identical(full, resumed)
    assert full.telemetry["faults"] == resumed.telemetry["faults"]


def test_resume_skips_torn_checkpoint(tmp_path):
    full = run_own(algorithms.make("fedavg"), seed=9, rounds=4,
                   executor="vmap")
    ck = str(tmp_path / "ck")
    run_own(algorithms.make("fedavg"), seed=9, rounds=3, executor="vmap",
            checkpoint_dir=ck)
    newest = sorted(glob.glob(os.path.join(ck, "state_*.npz")))[-1]
    with open(newest, "r+b") as f:
        f.truncate(64)
    resumed = run_own(algorithms.make("fedavg"), seed=9, rounds=4,
                      executor="vmap", checkpoint_dir=ck, resume=True)
    assert_histories_identical(full, resumed)


def test_resume_guards(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_own(algorithms.make("fedavg"), seed=0, rounds=1, executor="vmap",
                resume=True)
    # a fresh directory starts from scratch and fills up
    ck = tmp_path / "empty"
    ck.mkdir()
    h = run_own(algorithms.make("fedavg"), seed=0, rounds=2, executor="vmap",
                checkpoint_dir=str(ck), resume=True)
    assert len(h.records) == 2
    assert sorted(os.listdir(ck)) == ["state_000001.meta", "state_000001.npz",
                                      "state_000002.meta", "state_000002.npz"]


def test_algo_mismatch_on_resume_raises(tmp_path):
    ck = str(tmp_path / "ck")
    run_own(algorithms.make("fedavg"), seed=0, rounds=2, executor="vmap",
            checkpoint_dir=ck)
    with pytest.raises(ValueError, match="fedavg"):
        run_own(algorithms.make("fedgkd", buffer_m=3), seed=0, rounds=3,
                executor="vmap", checkpoint_dir=ck, resume=True)


_KILL_SCRIPT = """\
import dataclasses, os, sys
import numpy as np
from repro_torch.configs.paper import TOY
from repro_torch.core import algorithms, fl_loop
from repro_torch.data.pipeline import ClientData, FederatedData
from repro_torch.data.synthetic import SyntheticTabularTask

SIZES = (20, 45, 64, 100, 130, 150)
task = dataclasses.replace(TOY, n_clients=len(SIZES), participation=1.0,
                           batch_size=64, rounds=2, local_epochs=2)
gen = SyntheticTabularTask(task.num_classes, dim=task.feat_dim, seed=0)
clients = [ClientData(*gen.generate(n, seed=100 + i))
           for i, n in enumerate(SIZES)]
tx, ty = gen.generate(200, seed=999)
data = FederatedData(clients, tx, ty, np.zeros((len(SIZES),
                                                task.num_classes)))

def kill_at_3(rnd, server, model):
    if rnd == 3:        # three rounds checkpointed, then a SIGKILL-like end
        os._exit(17)

fl_loop.run_federated(task, algorithms.make("fedgkd", buffer_m=3), data,
                      seed=9, rounds=5, executor="vmap", device="cpu",
                      checkpoint_dir=sys.argv[1], round_callback=kill_at_3)
"""


def test_hard_kill_then_resume_matches_uninterrupted(tmp_path):
    """A checkpointing run ended by ``os._exit`` after round 3 (no
    teardown, as an OOM kill), resumed in this process: bit for bit the
    run that was never killed."""
    ck = tmp_path / "ck"
    ck.mkdir()
    script = tmp_path / "killed_run.py"
    script.write_text(_KILL_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in (os.environ.get("PYTHONPATH", ""),) if p]))
    proc = subprocess.run([sys.executable, str(script), str(ck)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 17, proc.stderr[-2000:]
    assert sorted(glob.glob(str(ck / "state_*.npz")))[-1].endswith(
        "state_000003.npz")

    def mk():
        return algorithms.make("fedgkd", buffer_m=3)

    full = run_own(mk(), seed=9, rounds=5, executor="vmap")
    resumed = run_own(mk(), seed=9, rounds=5, executor="vmap",
                      checkpoint_dir=str(ck), resume=True)
    assert_histories_identical(full, resumed)
