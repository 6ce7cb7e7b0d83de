"""The port's dense and hybrid LMs against the JAX package, on the CPU.

phi4-mini-3.8b and minitron-4b (RMSNorm, SwiGLU, GQA), granite-34b
(LayerNorm, GELU, biased q/k/v, MQA), internlm2-20b (an untied head, RoPE
theta 1e6) and zamba2-1.2b (the hybrid: Mamba-2 layers and one shared
attention + MLP block every 2 of them), each at the reference's smoke
config (d_model 128, vocab 503; 2 layers, the hybrid 4), from the
reference's initialisation loaded through the bridge, with tokens from
numpy seeds.  Checked, within TOL = 1e-5 (fp32, different summation
orders; logits and losses relative to their size where it exceeds 1, as
``test_torch_lm.py`` holds mamba2's): the config fields and the parameter
counts (the analytic ``param_count`` and the leaves of the initialised
tree equal to the reference's, and the analytic count within 15% of the
leaves, the reference's own bar: ``tests/test_arch_smoke.py:148``); the
forward logits; one FedGKD train step (loss, metrics and params after;
``:57``); SwiGLU alone; the registry (every name of ``ALL_ARCHS`` builds,
and each config's parameter counts equal the reference's); and
``launch.train``'s ``--fl-task`` path against the reference's on TOY.
One reference init and one jitted forward per architecture are shared
across the cases.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.configs import phi4_mini_3_8b as jax_phi4  # noqa: E402
from repro.configs.paper import PaperTask as JaxPaperTask  # noqa: E402
from repro.core.modelzoo import make_model as jax_make_model  # noqa: E402
from repro.core import fl_loop as jax_fl_loop  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.configs import list_archs as base_list_archs  # noqa: E402
from repro_torch.configs import phi4_mini_3_8b  # noqa: E402
from repro_torch.core import fl_loop, modelzoo  # noqa: E402
from repro_torch.data.synthetic import lm_token_batches  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
ARCHS = ["phi4-mini-3.8b", "minitron-4b", "granite-34b", "internlm2-20b",
         "zamba2-1.2b"]


def _max_diff(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(la, lb))


_INITS: dict = {}


def reference(arch):
    """(port cfg, reference cfg, the reference's init as numpy), made once
    per architecture."""
    if arch not in _INITS:
        jcfg = jax_get_smoke(arch)
        init = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jax_transformer.init(k, jcfg))(jax.random.PRNGKey(0)))
        _INITS[arch] = (get_smoke_config(arch), jcfg, init)
    return _INITS[arch]


def _tokens(seed, batch=2, seq=24, vocab=503):
    return lm_token_batches(np.random.default_rng(seed), batch, seq, vocab)


# --------------------------------------------------------------- registry

@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_and_full_config_fields_equal_reference(arch):
    for get, jget in ((get_smoke_config, jax_get_smoke),
                      (get_config, jax_get_config)):
        cfg, jcfg = get(arch), jget(arch)
        for f in dataclasses.fields(cfg):
            want = getattr(jcfg, f.name)
            got = getattr(cfg, f.name)
            assert (tuple(got) if f.name == "ssm" and got else got) == (
                tuple(want) if f.name == "ssm" and want else want), f.name
        assert cfg.segments() == jcfg.segments()


def test_phi4_long_variant_has_the_references_window():
    cfg, jcfg = phi4_mini_3_8b.long_variant(), jax_phi4.long_variant()
    assert cfg.attn_window == jcfg.attn_window == 4096
    assert phi4_mini_3_8b.full().attn_window is None


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    """The analytic count of the smoke and full configs equals the
    reference's; the initialised tree has the reference's keys, shapes and
    leaf count, and the analytic count is within the reference's 15% of
    it (its formula leaves out biases and the final norm)."""
    cfg, jcfg, init = reference(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert get_config(arch).param_count() == jax_get_config(arch).param_count()
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    got = {k: tuple(v.shape) for k, v in tree_paths(params)}
    want = {k: np.shape(v) for k, v in tree_paths(init)}
    assert got == want
    actual = sum(t.numel() for t in tree_leaves(params))
    assert actual == sum(np.size(v) for v in jax.tree_util.tree_leaves(init))
    assert abs(cfg.param_count() - actual) / actual < 0.15


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_arch_builds_its_configs(arch):
    """Every name of the reference's ``ALL_ARCHS`` is registered: the
    published and the smoke config build, with the reference's name,
    family, attention type and depths."""
    assert sorted(base_list_archs()) == sorted(ALL_ARCHS)
    for get, jget in ((get_config, jax_get_config),
                      (get_smoke_config, jax_get_smoke)):
        cfg, jcfg = get(arch), jget(arch)
        for f in ("name", "family", "attn_type", "n_layers", "enc_layers",
                  "first_k_dense", "frontend", "frontend_seq"):
            assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_of_every_arch_equal_reference(arch):
    """The analytic total and active parameter counts of the published and
    the smoke config, the reference's formula term for term (MLA, MoE,
    MTP, the encoder and cross-attention included)."""
    for get, jget in ((get_config, jax_get_config),
                      (get_smoke_config, jax_get_smoke)):
        cfg, jcfg = get(arch), jget(arch)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()


# ------------------------------------------------------------------ model

def test_swiglu_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    p = jax.tree_util.tree_map(np.asarray, jax_layers.swiglu_init(
        jax.random.PRNGKey(3), 32, 64))
    got = layers.swiglu(bridge.params_from_numpy(p), torch.from_numpy(x))
    want = jax_layers.swiglu(p, jnp.asarray(x))
    assert _max_diff(got.numpy(), want) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference(arch):
    cfg, jcfg, init = reference(arch)
    toks = _tokens(2)
    with torch.no_grad():
        logits, aux = transformer.forward(bridge.params_from_numpy(init), cfg,
                                          torch.from_numpy(toks))
    jlogits, _ = jax.jit(lambda p, t: jax_transformer.forward(p, jcfg, t))(
        init, jnp.asarray(toks))
    assert logits.dtype == torch.float32 and logits.shape == (2, 24, 503)
    scale = float(np.abs(np.asarray(jlogits)).max())
    assert _max_diff(logits.numpy(), jlogits) < TOL * max(1.0, scale)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_fedgkd_train_step_matches_reference(arch):
    cfg, jcfg, init = reference(arch)
    # a teacher that disagrees with the student: at a random init the
    # logits are large, so a scaled copy would give a KD term of ~0
    rng = np.random.default_rng(4)
    teacher_np = jax.tree_util.tree_map(
        lambda a: (a + 0.5 * rng.standard_normal(a.shape)).astype(a.dtype),
        init)
    toks = _tokens(5, seq=17)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jstep = jax.jit(jax_steps.make_train_step(
        jcfg, jax_sgd(momentum=0.9), kd_mode="teacher", gamma=0.2, lr=0.1))
    jparams, _, jm = jstep(init, teacher_np, jax_sgd(momentum=0.9).init(init),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    opt = sgd(momentum=0.9)
    step = steps.make_train_step(cfg, opt, kd_mode="teacher", gamma=0.2,
                                 lr=0.1)
    params = bridge.params_from_numpy(init)
    new, _, m = step(params, bridge.params_from_numpy(teacher_np),
                     opt.init(params),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce", "kd", "aux"):
        assert abs(float(m[k]) - float(jm[k])) < TOL * max(
            1.0, abs(float(jm[k]))), k
    assert float(m["kd"]) > 0
    assert _max_diff(bridge.params_to_numpy(new), jparams) < TOL


def test_hybrid_remat_gives_the_same_gradients():
    cfg, _, init = reference("zamba2-1.2b")
    toks = torch.from_numpy(_tokens(6, seq=17))
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


# -------------------------------------------------------------- --fl-task

def _fl_task_args(**kw):
    args = dict(fl_task="toy", fl_scale=0.1, rounds=2, clients=0,
                fl_width=16, executor="auto", algo="fedgkd", gamma=0.2,
                buffer_m=3, batches_per_round=2, device="cpu")
    args.update(kw)
    return type("Args", (), args)


def test_run_fl_task_toy_matches_reference(monkeypatch, capsys):
    """``--fl-task toy`` in both packages, the port from the reference's
    init (torch cannot replay ``jax.random``): the same round body and
    printed line, and the final accuracy and loss within TOL."""
    runs = {}
    real = modelzoo.make_model

    def with_reference_init(task, *args, **kwargs):
        jtask = JaxPaperTask(**dataclasses.asdict(task))
        init = jax.tree_util.tree_map(np.asarray, jax_make_model(
            jtask, *args, **kwargs).init(jax.random.PRNGKey(1)))
        return dataclasses.replace(
            real(task, *args, **kwargs),
            init=lambda gen: bridge.params_from_numpy(init))

    def capture(name, fn):
        def run(*a, **k):
            runs[name] = fn(*a, **k)
            return runs[name]
        return run

    monkeypatch.setattr(jax_fl_loop, "run_federated",
                        capture("ref", jax_fl_loop.run_federated))
    monkeypatch.setattr(fl_loop, "run_federated",
                        capture("port", fl_loop.run_federated))
    monkeypatch.setattr(fl_loop, "make_model", with_reference_init)
    assert jax_train.run_fl_task(_fl_task_args()) == 0
    assert train.run_fl_task(_fl_task_args()) == 0
    ref_line, port_line = [line for line in capsys.readouterr().out.splitlines()
                           if line.startswith("model=")]
    assert port_line == ref_line
    ref, port = runs["ref"], runs["port"]
    assert port.telemetry["round_body"] == ref.telemetry["round_body"]
    assert abs(port.final_acc - ref.final_acc) < TOL
    assert abs(port.records[-1].test_loss - ref.records[-1].test_loss) < TOL


def test_train_cli_fl_task_choices_and_device():
    with pytest.raises(SystemExit):
        train.main(["--fl-task", "mnist", "--device", "cpu"])
    assert train.main(["--fl-task", "toy", "--fl-scale", "0.05", "--rounds",
                       "1", "--batches-per-round", "1", "--device", "cpu"]) == 0
