"""The port's federated LM path against the JAX package, on the CPU.

At the smoke config of ``mamba2-2.7b`` (2 Mamba-2 layers, d_model 128,
vocab 503, N 16, P 16, chunk 16), from the reference's initialisation
loaded through the bridge, with inputs from numpy seeds.  Checked, each
within TOL = 1e-5 max-abs unless it says otherwise (fp32, different
summation orders): the registry (smoke fields, parameter counts, the
published config's bf16 caches); the token streams byte for byte; ``row_logsumexp`` against the
reference's Pallas kernel in interpret mode (whole blocks only: the
reference drops a ragged edge) and ``jax.nn.logsumexp``, with its
gradient; RMSNorm, one Mamba-2 block, the model's logits, the LM
cross-entropy and its gradient, one FedGKD train step (loss, metrics,
params after); ``remat`` leaving gradients as they are; and 2-round
``run_serial`` trajectories, FedGKD and FedAvg, 2 clients x 2 batches of
2 sequences of 40 tokens (39 positions: two chunks of 16 and a ragged 7).
The trajectories are compared on log(ppl), the eval CE, relative to its
size (perplexities are ~1e15 from a random init, and a CE of ~35 keeps
~4e-6 absolute in fp32), on the last step's loss likewise, and on the
final params; the largest diff each reached is in the assertion message
(on a CPU run: log(ppl) 5e-7 relative, params 1e-6).
"""
import dataclasses
import gc
import math
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.configs.paper import AG_NEWS as JAX_AG_NEWS  # noqa: E402
from repro.configs.paper import distilbert_class_config as jax_distilbert  # noqa: E402
from repro.data.synthetic import lm_token_batches as jax_tokens  # noqa: E402
from repro.kernels.kd_kl import kernel as jax_kd_kernel  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.paper import AG_NEWS, distilbert_class_config  # noqa: E402
from repro_torch.data.synthetic import lm_token_batches  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.kd_kl.ops import row_logsumexp  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import layers, ssm, transformer  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
SRC = Path(__file__).resolve().parent.parent / "src"
ARCH = "mamba2-2.7b"


def _max_diff(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def smoke():
    """(port cfg, reference cfg, reference init as numpy)."""
    jcfg = jax_get_smoke(ARCH)
    init = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jax_transformer.init(k, jcfg))(jax.random.PRNGKey(0)))
    return get_smoke_config(ARCH), jcfg, init


def _tokens(seed, batch=2, seq=40, vocab=503):
    return lm_token_batches(np.random.default_rng(seed), batch, seq, vocab)


# --------------------------------------------------------------- registry

def test_smoke_config_fields_equal_reference():
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke(ARCH)
    shared = {f.name for f in dataclasses.fields(cfg)}
    for name in shared:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert tuple(cfg.ssm) == tuple(jcfg.ssm)
    assert cfg.segments() == jcfg.segments() == [("mamba", 2)]


@pytest.mark.parametrize("which", ["full", "smoke", "distilbert"])
def test_param_count_equals_reference(which):
    if which == "distilbert":
        cfg, jcfg = (distilbert_class_config(AG_NEWS),
                     jax_distilbert(JAX_AG_NEWS))
    else:
        get, jget = ((get_config, jax_get_config) if which == "full"
                     else (get_smoke_config, jax_get_smoke))
        cfg, jcfg = get(ARCH), jget(ARCH)
    assert cfg.param_count() == jcfg.param_count()


def test_full_config_is_the_published_one():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert (cfg.d_model, cfg.n_layers, cfg.vocab_size) == (2560, 64, 50280)
    assert tuple(cfg.ssm) == tuple(jcfg.ssm)
    assert (cfg.param_dtype, cfg.remat) == ("bfloat16", True)
    assert cfg.replace(n_layers=4).param_count() == 289_561_216


def test_published_config_caches_take_bf16():
    """bf16 is ported (ROADMAP A15.3): the published config's caches come
    in bf16, the SSM state in fp32, as the reference's."""
    cfg = get_config(ARCH).replace(n_layers=1)
    assert (cfg.pdtype, cfg.adtype) == (torch.bfloat16, torch.bfloat16)
    cache = transformer.init_cache(cfg, 1, 4)["seg0"]
    assert (cache.conv_state.dtype, cache.ssm_state.dtype) == (
        torch.bfloat16, torch.float32)


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("seed,batch,seq,vocab", [(0, 2, 40, 503),
                                                  (9999, 8, 64, 50280)])
def test_lm_token_batches_byte_identical(seed, batch, seq, vocab):
    got = lm_token_batches(np.random.default_rng(seed), batch, seq, vocab)
    want = jax_tokens(np.random.default_rng(seed), batch, seq, vocab)
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()


def test_client_batches_byte_identical():
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke(ARCH)
    got = train.client_batches(cfg, 3, 2, 2, 17, seed=4)
    want = jax_train.client_batches(jcfg, 3, 2, 2, 17, seed=4)
    assert got.shape == (3, 2, 2, 17) and got.tobytes() == want.tobytes()


# ------------------------------------------------------- row logsumexp (B6)

@pytest.mark.parametrize("t,v,block_rows,block_vocab,temp", [
    (256, 1024, 64, 256, 1.0), (128, 2048, 128, 512, 2.0),
    (64, 503, 64, 503, 0.5)])
def test_row_logsumexp_matches_reference_kernel(t, v, block_rows,
                                                block_vocab, temp):
    """Whole-block shapes: the reference's grid covers no ragged edge."""
    logits = np.random.default_rng(t + v).standard_normal((t, v)).astype(
        np.float32) * 3
    reset_launches()
    got = row_logsumexp(torch.from_numpy(logits), temperature=temp).numpy()
    assert LAUNCHES["row_logsumexp"] == 0
    want = jax_kd_kernel.row_logsumexp(
        jnp.asarray(logits), temperature=temp, block_rows=block_rows,
        block_vocab=block_vocab, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax.nn.logsumexp(jnp.asarray(logits) / temp, -1)),
        rtol=0, atol=TOL)


@pytest.mark.parametrize("t,v,temp", [(300, 1100, 1.0), (7, 13, 2.0)])
def test_row_logsumexp_any_shape_and_gradient(t, v, temp):
    rng = np.random.default_rng(v)
    logits = rng.standard_normal((t, v)).astype(np.float32) * 3
    g = rng.standard_normal(t).astype(np.float32)
    live = torch.from_numpy(logits).requires_grad_(True)
    out = row_logsumexp(live, temperature=temp)
    (out * torch.from_numpy(g)).sum().backward()
    jl = jnp.asarray(logits)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(jax.nn.logsumexp(jl / temp, -1)),
        rtol=0, atol=TOL)
    want = jax.grad(lambda x: jnp.sum(jax.nn.logsumexp(x / temp, -1) * g))(jl)
    np.testing.assert_allclose(live.grad.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


# ----------------------------------------------------------------- model

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(x)).numpy()
    want = jax_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


def test_mamba2_block_matches_reference(smoke):
    cfg, jcfg, init = smoke
    p = jax.tree_util.tree_map(lambda a: a[0], init["seg0"]["mixer"])
    x = np.random.default_rng(1).standard_normal((2, 39, 128)).astype(
        np.float32)
    y, final = ssm.mamba2_forward(bridge.params_from_numpy(p),
                                  torch.from_numpy(x), cfg.ssm)
    jy, jfinal = jax.jit(lambda p, x: jax_ssm.mamba2_forward(p, x, jcfg.ssm))(
        p, jnp.asarray(x))
    assert _max_diff(y.numpy(), jy) < TOL
    assert _max_diff(final.numpy(), jfinal) < TOL


def test_logits_match_reference(smoke):
    cfg, jcfg, init = smoke
    toks = _tokens(2)
    logits, aux = transformer.forward(bridge.params_from_numpy(init), cfg,
                                      torch.from_numpy(toks))
    jlogits, _ = jax.jit(lambda p, t: jax_transformer.forward(p, jcfg, t))(
        init, jnp.asarray(toks))
    assert logits.dtype == torch.float32 and logits.shape == (2, 40, 503)
    scale = float(np.abs(np.asarray(jlogits)).max())
    assert _max_diff(logits.detach().numpy(), jlogits) < TOL * max(1.0, scale)
    assert float(aux) == 0.0


def test_lm_cross_entropy_value_and_gradient():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 503)).astype(np.float32) * 4
    labels = rng.integers(0, 503, (2, 9)).astype(np.int32)
    labels[0, :3] = -1                                   # ignored positions
    live = torch.from_numpy(logits).requires_grad_(True)
    ce = steps.lm_cross_entropy(live, torch.from_numpy(labels))
    ce.backward()
    jce, jgrad = jax.value_and_grad(
        lambda l: jax_steps.lm_cross_entropy(l, jnp.asarray(labels)))(
        jnp.asarray(logits))
    assert abs(ce.item() - float(jce)) < TOL
    np.testing.assert_allclose(live.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=TOL)


def test_teacher_train_step_matches_reference(smoke):
    cfg, jcfg, init = smoke
    teacher_np = jax.tree_util.tree_map(lambda a: a * 0.9, init)
    toks = _tokens(5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jstep = jax.jit(jax_steps.make_train_step(
        jcfg, jax_sgd(momentum=0.9), kd_mode="teacher", gamma=0.2, lr=0.1))
    jparams, _, jm = jstep(init, teacher_np, jax_sgd(momentum=0.9).init(init),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    opt = sgd(momentum=0.9)
    step = steps.make_train_step(cfg, opt, kd_mode="teacher", gamma=0.2, lr=0.1)
    params = bridge.params_from_numpy(init)
    new, _, m = step(params, bridge.params_from_numpy(teacher_np),
                     opt.init(params),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce", "kd", "aux"):
        assert abs(float(m[k]) - float(jm[k])) < TOL * max(1.0, abs(float(jm[k]))), k
    assert _max_diff(bridge.params_to_numpy(new), jparams) < TOL


def test_remat_gives_the_same_gradients(smoke):
    cfg, _, init = smoke
    toks = torch.from_numpy(_tokens(6))
    grads = []
    for remat in (False, True):
        params = bridge.params_from_numpy(init)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        logits, _ = transformer.forward(params, cfg.replace(remat=remat),
                                        toks[:, :-1])
        steps.lm_cross_entropy(logits, toks[:, 1:]).backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads, strict=True):
        assert float((a - b).abs().max()) < 1e-6


# ------------------------------------------------------------ trajectory

RUN = dict(rounds=2, n_clients=2, batches_per_round=2, batch=2, seq=40,
           lr=0.1, seed=0)


@pytest.mark.parametrize("algo", ["fedgkd", "fedavg"])
def test_run_serial_matches_reference(smoke, monkeypatch, algo):
    cfg, jcfg, init = smoke
    want = jax_train.run_serial(jcfg, algo=algo, verbose=False, **RUN)
    monkeypatch.setattr(transformer, "init",
                        lambda gen, cfg: bridge.params_from_numpy(init))
    got = train.run_serial(cfg, algo=algo, verbose=False, device="cpu", **RUN)
    ce_diff = max(abs(math.log(g["ppl"]) - math.log(w["ppl"]))
                  / max(1.0, math.log(w["ppl"]))
                  for g, w in zip(got["history"], want["history"], strict=True))
    loss_diff = max(abs(g["loss"] - w["loss"])
                    for g, w in zip(got["history"], want["history"]))
    param_diff = _max_diff(bridge.params_to_numpy(got["params"]),
                           want["params"])
    msg = (f"{algo}: log(ppl) rel diff {ce_diff:.3e}, loss diff {loss_diff:.3e}, "
           f"params diff {param_diff:.3e}")
    assert ce_diff < TOL and param_diff < TOL, msg
    assert loss_diff < TOL * max(1.0, abs(want["history"][-1]["loss"])), msg


@pytest.fixture
def no_cyclic_gc():
    """Python's cyclic collector off for the test: what it would free (a
    tensor held by a reference cycle) stays alive, as it does on the card
    until the collector happens to run."""
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    yield
    if was:
        gc.enable()


def test_tree_flatten_leaves_no_reference_cycle(no_cyclic_gc):
    leaves = [torch.zeros(3) for _ in range(3)]
    refs = [weakref.ref(t) for t in leaves]
    tree = {"a": leaves[0], "b": (leaves[1], [leaves[2], None])}
    flat, rebuild = tree_flatten(tree)
    assert rebuild(flat)["b"][1][0] is leaves[2]
    del leaves, tree, flat, rebuild
    assert all(r() is None for r in refs)


@pytest.mark.parametrize("algo", ["fedgkd", "fedavg"])
def test_run_serial_frees_each_rounds_clients_and_teacher(smoke, algo,
                                                          monkeypatch,
                                                          no_cyclic_gc):
    """By the round's evaluation the clients' trained params and the
    teacher are gone, without the cyclic collector: what stays is the
    global model and the FedGKD buffer.  (At phi4-mini's width in fp32 a
    round holds ~5 GiB a param set, so a set held a round longer is what
    takes the card out of memory.)"""
    cfg = smoke[0]
    held = []

    def track(tree):
        held.extend(weakref.ref(t) for t in tree_leaves(tree))

    def weighted_average(trees, weights):       # the clients' params
        track(trees)
        return real_average(trees, weights)

    def ensemble_average(models):               # the teacher
        teacher = real_ensemble(models)
        track(teacher)
        return teacher

    def eval_ppl(params, cfg, tokens):
        alive = sum(r() is not None for r in held)
        assert alive == 0, f"{alive} tensors of the round still alive"
        return real_eval(params, cfg, tokens)

    real_average, real_ensemble, real_eval = (
        train.weighted_average, train.ensemble_average, train.eval_ppl)
    monkeypatch.setattr(train, "weighted_average", weighted_average)
    monkeypatch.setattr(train, "ensemble_average", ensemble_average)
    monkeypatch.setattr(train, "eval_ppl", eval_ppl)
    train.run_serial(cfg, algo=algo, verbose=False, device="cpu",
                     **dict(RUN, seq=20))
    assert held


# ------------------------------------------------------------------- CLI

def _cli(*extra):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--rounds", "1", "--clients", "2",
         "--batches-per-round", "1", "--batch", "2", "--seq", "20", *extra],
        env=env, capture_output=True, text=True, timeout=300)


def test_cli_runs_on_the_cpu_when_asked():
    out = _cli("--device", "cpu")
    assert out.returncode == 0, out.stderr
    ppl = float(out.stdout.strip().splitlines()[-1].split(":")[1])
    assert math.isfinite(ppl)


def test_cli_defaults_to_the_card_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", ARCH, "--smoke", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--fl-task", "cifar10"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", ARCH, "--smoke", "--sharded"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", ARCH])        # the published bf16 config


def test_cli_straggler_tail_reports_the_references_sim_seconds():
    """``--straggler-frac 0.5`` on the CPU: the run finishes and its
    simulated barrier time is the reference clock's over the rounds."""
    out = _cli("--device", "cpu", "--straggler-frac", "0.5",
               "--straggler-slowdown", "3.0", "--rounds", "2")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert math.isfinite(float(lines[-2].split(":")[1]))
    total = float(lines[-1].split(":")[1].split()[0])
    clock = jax_train.make_round_clock(2, straggler_frac=0.5,
                                       straggler_slowdown=3.0, seed=0)
    assert total == 2 * clock(1)
    assert total > 0.0
