"""The one-client-per-device LM round against the JAX package, on the CPU.

``steps.make_aggregate_step`` and ``train.run_sharded`` /
``make_parallel_round``: the reference runs the clients as one
``shard_map`` program over a mesh of devices and aggregates with a
``psum``; the port runs them one after another, each on its own device of
a list (which may repeat a device), and gathers their params to the first
device for the weighted mean.

Tolerances, stated before any comparison:

* the aggregation: the reference's weighted mean in one client is the
  client's params times w / w, exactly; over clients each term is
  ``p · (w / total)`` in fp32, summed in client order and cast back, the
  same arithmetic in both packages, so the port is held to it exactly;
* ``run_sharded`` on one CPU device against the reference's on one CPU
  device (the phi4-mini smoke config in fp32, from the reference's init):
  1e-5, as ``tests/test_torch_lm.py`` holds the serial trajectories
  (log(ppl) relative to its size, the loss likewise, params absolute);
* ``run_sharded(devices=["cpu"] * 2)`` against ``run_serial(n_clients=2)``
  from the same init: the same steps on the same batches, equal weights
  (0.5 each, exact) and fp32 sums in client order, so the params and
  the perplexity are expected to be equal; the test holds them to 0.
"""
import functools
import math
import operator

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.sharding import shard_map_compat  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
ARCH = "phi4-mini-3.8b"
RUN = dict(rounds=1, batches_per_round=2, batch=2, seq=9, lr=0.1, seed=0)


@pytest.fixture(scope="module")
def smoke():
    """(port cfg, reference cfg, the reference's init as numpy, the
    reference's ``run_sharded`` on its one CPU device, which starts from
    that init: its own ``transformer.init`` at the seed, jitted once)."""
    jcfg = jax_get_smoke(ARCH)
    init = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jax_transformer.init(k, jcfg))(jax.random.PRNGKey(0)))
    assert len(jax.devices()) == 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_transformer, "init", lambda key, cfg: init)
        want = jax_train.run_sharded(jcfg, verbose=False, **RUN)
    return get_smoke_config(ARCH), jcfg, init, want


def _diff(a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(x, np.float32)
                                   - np.asarray(y, np.float32))))
               for x, y in zip(tree_leaves(a), jax.tree_util.tree_leaves(b),
                               strict=True))


def _from(init):
    return lambda gen, cfg: bridge.params_from_numpy(init)


def test_aggregate_step_weighted_mean_matches_reference():
    """``tests/test_steps.py:125``'s case, one client of weight 3 whose
    params are ones, in both packages."""
    mesh = jax.make_mesh((1,), ("pod",))
    fn = shard_map_compat(jax_steps.make_aggregate_step("pod"), mesh,
                          in_specs=(P(), P()), out_specs=P())
    want = fn({"w": jnp.ones((2,))}, jnp.asarray(3.0))
    got = steps.make_aggregate_step()([{"w": torch.ones(2)}], [3.0])
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["w"].numpy(), 1.0)


def test_aggregate_step_bf16_weighted_mean():
    """Three bf16 clients of weights 1, 2 and 3 on the CPU "devices": each
    term p · (w / total) in fp32, summed in client order, cast to bf16, as
    the reference's psum computes it (written out in jnp); the fp32 leaf
    stays fp32."""
    rng = np.random.default_rng(0)
    trees = [{"w": rng.standard_normal((4, 3)).astype(jnp.bfloat16),
              "n": {"b": rng.standard_normal(5).astype(np.float32)}}
             for _ in range(3)]
    weights = np.asarray([1.0, 2.0, 3.0], np.float32)
    total = jnp.sum(jnp.asarray(weights))
    want = jax.tree_util.tree_map(
        lambda *ps: functools.reduce(operator.add, [
            jnp.asarray(p) * (jnp.asarray(w) / total)
            for p, w in zip(ps, weights)]).astype(ps[0].dtype), *trees)
    got = steps.make_aggregate_step()(
        [bridge.params_from_numpy(t) for t in trees], weights)
    assert got["w"].dtype == torch.bfloat16
    assert got["n"]["b"].dtype == torch.float32
    for a, b in zip(tree_leaves(bridge.params_to_numpy(got)),
                    jax.tree_util.tree_leaves(want), strict=True):
        assert a.tobytes() == np.asarray(b).tobytes()


def test_run_sharded_one_device_matches_reference(smoke, monkeypatch):
    cfg, _, init, want = smoke
    monkeypatch.setattr(transformer, "init", _from(init))
    got = train.run_sharded(cfg, devices=["cpu"], verbose=False, **RUN)
    (g,), (w,) = got["history"], want["history"]
    ce = abs(math.log(g["ppl"]) - math.log(w["ppl"])) / max(
        1.0, math.log(w["ppl"]))
    loss = abs(g["loss"] - w["loss"]) / max(1.0, abs(w["loss"]))
    params = _diff(bridge.params_to_numpy(got["params"]), want["params"])
    assert ce < TOL and loss < TOL and params < TOL, (ce, loss, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_cpu_devices_equal_run_serial(smoke, monkeypatch, dtype):
    """Two clients on a repeated CPU device against ``run_serial``'s two
    clients, fp32 and at the published bf16."""
    cfg, jcfg, init, _ = smoke
    cfg = cfg.replace(param_dtype=dtype, activation_dtype=dtype)
    if dtype == "bfloat16":
        init = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jax_transformer.init(k, jcfg.replace(
                param_dtype=dtype, activation_dtype=dtype)))(
            jax.random.PRNGKey(0)))
    monkeypatch.setattr(transformer, "init", _from(init))
    sharded = train.run_sharded(cfg, devices=["cpu"] * 2, verbose=False,
                                **RUN)
    serial = train.run_serial(cfg, n_clients=2, device="cpu", verbose=False,
                              **RUN)
    for a, b in zip(tree_leaves(sharded["params"]),
                    tree_leaves(serial["params"]), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert sharded["history"][0]["ppl"] == serial["history"][0]["ppl"]
    assert math.isfinite(sharded["history"][0]["loss"])


def test_sharded_cli_runs_on_one_cpu_client(capsys):
    assert train.main(["--arch", ARCH, "--smoke", "--sharded", "--device",
                       "cpu", "--rounds", "1", "--batches-per-round", "1",
                       "--batch", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "[fedgkd/sharded] round 1/1" in out
    assert math.isfinite(float(out.strip().splitlines()[-1].split(":")[1]))


def test_sharded_devices_default_to_the_cards(monkeypatch):
    """Without a device list the clients are the host's CUDA cards; without
    a card that raises, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.sharded_devices()
    assert train.sharded_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="at least one device"):
        train.sharded_devices([])
