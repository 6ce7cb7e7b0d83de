"""The port's MoE family against the JAX package, on the CPU.

``models.moe`` (the router, the capacity-bucketed dispatch by index
operations, the load-balance loss, shared experts), the MoE layers and
DeepSeek-V3's multi-token prediction head in the model stack, the MTP
term of the loss, mixtral-8x7b in the registry, decode and ``ServeLoop``
over MoE layers, and ``run_serial`` trajectories.  Configs: mixtral's
smoke config (2 MoE layers, d_model 128, 4 experts of d_ff 64, top-2,
softmax gates, groups of 64 tokens, window 8, vocab 503) and a variant
with DeepSeek's options on GQA (sigmoid scores renormalised over the
top-2, one shared expert, ``first_k_dense=1``, ``mtp_depth=1``), which the
reference accepts through ``replace``.  Weights are the reference's
initialisation loaded through the bridge; inputs come from numpy seeds.

Tolerance, stated before any comparison: TOL = 1e-5 of the compared
value's largest magnitude (or absolute where that is below 1): fp32 in
both packages, different summation orders.  The bf16 step is held as
``tests/test_torch_bf16.py`` holds the other families: no further from
the reference's fp32 run than twice the reference's bf16 run, or one
bf16 ulp.  Token outputs (greedy decode, ``ServeLoop``) are equal.

The reference runs jitted, each function compiled once per config and
shared across the cases (its eager MoE stack takes minutes).
"""
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import lm_token_batches  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402
from test_torch_bf16 import (BF16, FP32, _SharedStepJax, _up,  # noqa: E402
                             assert_bf16_parity, assert_dtypes_equal)
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
ARCH = "mixtral-8x7b"
STEP = dict(gamma=0.2, lr=0.1)


def _diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64)), initial=0.0))


def _close(what, got, want, tol=TOL):
    want = np.asarray(want)
    err = _diff(got, want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _close_trees(what, got, want, tol=TOL):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        _close(f"{what}, leaf {i}", a, b, tol)


def _deepseek_options(cfg):
    """DeepSeek-V3's router options on mixtral's smoke config (GQA)."""
    return cfg.replace(moe=cfg.moe._replace(router_type="sigmoid",
                                            n_shared_experts=1),
                       first_k_dense=1, mtp_depth=1)


VARIANTS = {
    "mixtral": (lambda: jax_get_smoke(ARCH), lambda: get_smoke_config(ARCH)),
    "deepseek-options": (lambda: _deepseek_options(jax_get_smoke(ARCH)),
                         lambda: _deepseek_options(get_smoke_config(ARCH))),
}

_REF: dict = {}


def reference(name):
    """(port cfg, reference cfg, the reference's init as numpy, its jitted
    forward, its jitted FedGKD step), once per variant."""
    if name not in _REF:
        jmake, make = VARIANTS[name]
        jcfg = jmake()
        init = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jax_transformer.init(k, jcfg))(jax.random.PRNGKey(0)))
        fwd = jax.jit(lambda p, t: jax_transformer.forward(p, jcfg, t))
        step = jax.jit(jax_steps.make_train_step(
            jcfg, jax_sgd(momentum=0.9), kd_mode="teacher", **STEP))
        _REF[name] = (make(), jcfg, init, fwd, step)
    return _REF[name]


def _tokens(seed, batch=2, seq=33):
    return lm_token_batches(np.random.default_rng(seed), batch, seq, 503)


# ---------------------------------------------------------------- moe_apply

# (router, tokens, group, capacity factor, shared experts): one group and
# several, the published capacity and one that forces drops
MOE_CASES = {
    "softmax-one-group": ("softmax", 64, 64, 1.25, 0),
    "softmax-4-groups": ("softmax", 256, 64, 1.25, 0),
    "sigmoid-4-groups": ("sigmoid", 256, 64, 1.25, 0),
    "softmax-drops": ("softmax", 256, 64, 0.5, 0),
    "sigmoid-shared-drops": ("sigmoid", 256, 64, 0.5, 1),
}
_MOE: dict = {}


def moe_case(name):
    """(port cfg, params as numpy, x, the reference's out, aux, and its
    gradients of ``_moe_loss`` for the params and x), once per case."""
    if name not in _MOE:
        router, t, group, cf, shared = MOE_CASES[name]
        jcfg = jax_moe.MoEConfig(d_model=32, d_ff=24, n_experts=4, top_k=2,
                                 n_shared_experts=shared,
                                 shared_d_ff=16 if shared else 0,
                                 capacity_factor=cf, group_size=group,
                                 router_type=router)
        p = jax.tree_util.tree_map(np.asarray, jax_moe.moe_init(
            jax.random.PRNGKey(len(_MOE)), jcfg))
        x = np.random.default_rng(7).standard_normal(
            (2, t // 2, 32)).astype(np.float32)
        out, aux = jax.jit(lambda p, x: jax_moe.moe_apply(p, x, jcfg))(p, x)

        def loss(p, x):
            o, a = jax_moe.moe_apply(p, x, jcfg)
            return jnp.sum(o * jnp.cos(o)) + 3.0 * a

        grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
        _MOE[name] = (moe.MoEConfig(*jcfg), p, x, np.asarray(out),
                      float(aux), jax.tree_util.tree_map(np.asarray, grads))
    return _MOE[name]


def _reference_keep(p, x, cfg):
    """The reference's kept (group, token, choice) entries, by its own
    router and its slot formula (``repro/models/moe.py:93-98``)."""
    g = min(cfg.group_size, x.shape[0] * x.shape[1])
    xg = jnp.asarray(x).reshape(-1, g, x.shape[-1])
    cap = max(1, int(math.ceil(g * cfg.top_k / cfg.n_experts
                               * cfg.capacity_factor)))
    jcfg = jax_moe.MoEConfig(*cfg)
    keeps = []
    for xi in xg:
        _, top_idx, _ = jax_moe.router_probs(p, xi, jcfg)
        onehot = jax.nn.one_hot(top_idx, cfg.n_experts, dtype=jnp.int32)
        flat = onehot.reshape(g * cfg.top_k, cfg.n_experts)
        pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, axis=-1)
        keeps.append(np.asarray(pos < cap).reshape(g, cfg.top_k))
    return np.stack(keeps)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case):
    """The output, the load-balance loss (times its coefficient) and, where
    the capacity drops entries, the dropped set itself."""
    cfg, p, x, want, want_aux, _ = moe_case(case)
    with torch.no_grad():
        out, aux = moe.moe_apply(bridge.params_from_numpy(p),
                                 torch.from_numpy(x), cfg)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    _close("out", out.numpy(), want)
    _close("aux", float(aux), want_aux)
    t = x.shape[0] * x.shape[1]
    g = min(cfg.group_size, t)
    n = t // g
    _, top_idx, _ = moe.router_probs(bridge.params_from_numpy(p),
                                     torch.from_numpy(x).reshape(n, g, -1),
                                     cfg)
    _, keep = moe.dispatch_plan(top_idx, moe.capacity(g, cfg), cfg.n_experts)
    ref_keep = _reference_keep(p, x, cfg)
    assert np.array_equal(keep.numpy(), ref_keep)
    if cfg.capacity_factor < 1:
        assert (~ref_keep).sum() > 0, "the case drops no entry"
        # a token with every choice dropped keeps its residual only: a
        # zero routed output, as in the reference
        gone = ~ref_keep.any(-1).reshape(-1)
        if gone.any() and not cfg.n_shared_experts:
            assert np.all(want.reshape(-1, 32)[gone] == 0)
            assert np.all(out.numpy().reshape(-1, 32)[gone] == 0)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_gradients_match_reference(case):
    """The gradients of sum(o·cos o) + 3·aux for the router, the experts,
    the shared expert and x, against ``jax.grad`` of the same scalar."""
    cfg, p, x, _, _, (gp, gx) = moe_case(case)
    params = bridge.params_from_numpy(p)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    o, a = moe.moe_apply(params, xt, cfg)
    (torch.sum(o * torch.cos(o)) + 3.0 * a).backward()
    names = [k for k, _ in tree_paths(params)]
    assert names == [k for k, _ in tree_paths(gp)]
    for name, t, w in zip(names, leaves, jax.tree_util.tree_leaves(gp)):
        _close(f"d/d{name}", t.grad.numpy(), w)
    _close("d/dx", xt.grad.numpy(), gx)


def test_topk_ties_go_to_the_lower_expert():
    """Equal router scores: the lower expert index first, as
    ``lax.top_k`` orders them."""
    scores = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9]])
    vals, idx = moe._top_k(scores, 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(scores.numpy()), 3)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[1, 2, 4]]
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


def test_moe_group_count_must_divide_the_tokens():
    cfg = moe.MoEConfig(d_model=8, d_ff=4, n_experts=2, top_k=1,
                        group_size=4)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="not divisible"):
        moe.moe_apply(p, torch.zeros(1, 6, 8), cfg)


def test_moe_active_params_equal_reference():
    for cfg in (get_config(ARCH).moe,
                _deepseek_options(get_smoke_config(ARCH)).moe):
        assert moe.moe_active_params(cfg) == jax_moe.moe_active_params(
            jax_moe.MoEConfig(*cfg))


# ------------------------------------------------------------- registry

def test_mixtral_config_fields_equal_reference():
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke_config(ARCH), jax_get_smoke(ARCH))):
        for f in dataclasses.fields(cfg):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            assert (tuple(got) if f.name == "moe" else got) == (
                tuple(want) if f.name == "moe" else want), f.name
        assert cfg.segments() == jcfg.segments()
    assert get_config(ARCH).moe.router_type == "softmax"


@pytest.mark.parametrize("depth", [1, 2, 32])
def test_param_counts_of_mixtral_at_depth_equal_reference(depth):
    cfg = get_config(ARCH).replace(n_layers=depth)
    jcfg = jax_get_config(ARCH).replace(n_layers=depth)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.segments() == jcfg.segments() == [("moe", depth)]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_smoke_variant_params_equal_reference(name):
    """The analytic counts, the segments, and the initialised tree's keys,
    shapes and dtypes (the router fp32 in a bf16 model) against the
    reference's."""
    cfg, jcfg, init, _, _ = reference(name)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.segments() == jcfg.segments()
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    assert ({k: tuple(v.shape) for k, v in tree_paths(params)}
            == {k: np.shape(v) for k, v in tree_paths(init)})
    bf = transformer.init(torch.Generator().manual_seed(0),
                          cfg.replace(**BF16))
    assert_dtypes_equal(bf, jax.eval_shape(lambda: jax_transformer.init(
        jax.random.PRNGKey(0), jcfg.replace(**BF16))), "bf16 init")
    assert bf["seg" + str(len(cfg.segments()) - 1)]["moe"]["router"][
        "w"].dtype == torch.float32


def test_a_moe_family_without_moe_config_builds_dense_layers():
    """As in the reference: the segments follow the ``MoEConfig``."""
    cfg = get_smoke_config("phi4-mini-3.8b").replace(family="moe")
    jcfg = jax_get_smoke("phi4-mini-3.8b").replace(family="moe")
    assert cfg.segments() == jcfg.segments() == [("dense", 2)]


def test_bridge_round_trips_moe_and_mtp_leaves_in_bf16():
    """The reference's bf16 init of the DeepSeek-option variant (router
    fp32, experts (E, D, F)/(E, F, D), the shared expert, ``mtp``) into the
    port and back, bit for bit."""
    _, _, init, _ = bf16_reference()
    params = bridge.params_from_numpy(init)
    assert_dtypes_equal(params, init, "bf16 init through the bridge")
    m = params["seg1"]["moe"]
    assert m["router"]["w"].dtype == torch.float32
    assert m["gate"].dtype == torch.bfloat16
    assert tuple(m["gate"].shape) == (1, 4, 128, 64)
    assert tuple(m["down"].shape) == (1, 4, 64, 128)
    assert sorted(m["shared"]) == ["down", "gate", "up"]
    assert sorted(params["mtp"]) == ["block", "final_norm", "norm_e",
                                     "norm_h", "proj"]
    back = bridge.params_to_numpy(params)
    assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
               for a, b in zip(jax.tree_util.tree_leaves(back),
                               jax.tree_util.tree_leaves(init)))


# ----------------------------------------------------------------- model

@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_logits_and_aux_match_reference(name):
    cfg, _, init, fwd, _ = reference(name)
    toks = _tokens(2)[:, :-1]
    want, want_aux = fwd(init, toks)
    with torch.no_grad():
        got, aux = transformer.forward(bridge.params_from_numpy(init), cfg,
                                       torch.from_numpy(toks))
    _close("logits", got.numpy(), want)
    _close("aux", float(aux), float(want_aux))
    assert float(aux) > 0


@pytest.mark.parametrize("name", list(VARIANTS))
def test_fedgkd_train_step_matches_reference(name):
    """One FedGKD step (a teacher that disagrees with the student): the
    loss and its terms (``mtp_ce`` with the MTP head), the params after."""
    cfg, _, init, _, jstep = reference(name)
    rng = np.random.default_rng(4)
    teacher = jax.tree_util.tree_map(
        lambda a: (a + 0.5 * rng.standard_normal(a.shape)).astype(a.dtype),
        init)
    toks = _tokens(5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jp, _, jm = jstep(init, teacher, jax_sgd(momentum=0.9).init(init),
                      jax.tree_util.tree_map(jnp.asarray, batch))
    opt = sgd(momentum=0.9)
    step = steps.make_train_step(cfg, opt, kd_mode="teacher", **STEP)
    params = bridge.params_from_numpy(init)
    new, _, m = step(params, bridge.params_from_numpy(teacher),
                     opt.init(params),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    keys = ["loss", "ce", "kd", "aux"] + (["mtp_ce"] if cfg.mtp_depth else [])
    assert sorted(m) == sorted(keys) == sorted(jm)
    for k in keys:
        _close(k, float(m[k]), float(jm[k]))
    assert float(m["kd"]) > 0 and float(m["aux"]) > 0
    _close_trees("params after the step", new, jp)


def test_remat_keeps_the_summed_aux_and_the_gradients():
    cfg, _, init, _, _ = reference("deepseek-options")
    toks = torch.from_numpy(_tokens(6))
    outs = []
    for remat in (False, True):
        params = bridge.params_from_numpy(init)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        logits, aux = transformer.forward(params, cfg.replace(remat=remat),
                                          toks[:, :-1])
        (steps.lm_cross_entropy(logits, toks[:, 1:]) + aux).backward()
        outs.append((float(aux), [t.grad for t in leaves]))
    (a0, g0), (a1, g1) = outs
    assert a0 == a1 > 0
    for a, b in zip(g0, g1, strict=True):
        if a is None:
            assert b is None
        else:
            assert float((a - b).abs().max()) < 1e-6


_BF16: dict = {}


def bf16_reference():
    """(reference bf16 cfg, its fp32 twin, two bf16 inits as numpy) of the
    DeepSeek-option variant, made once."""
    if not _BF16:
        _, jcfg, _, _, _ = reference("deepseek-options")
        jcfg = jcfg.replace(**BF16)
        init_fn = jax.jit(lambda k: jax_transformer.init(k, jcfg))
        _BF16["ref"] = (jcfg, jcfg.replace(**FP32), *(
            jax.tree_util.tree_map(np.asarray, init_fn(jax.random.PRNGKey(i)))
            for i in (0, 5)))
    return _BF16["ref"]


def test_bf16_fedgkd_step_matches_reference():
    """One FedGKD step of the DeepSeek-option variant in bf16 (the router
    fp32; the MTP head) from a zero momentum, held as
    ``tests/test_torch_bf16.py`` holds the other families: the loss terms,
    the params after and the momentum (the gradients), dtypes leaf for
    leaf."""
    from repro.core.distillation import ensemble_average as jax_ensemble
    from repro_torch.core.distillation import ensemble_average

    jcfg, jcfg32, init, other = bf16_reference()
    teacher = jax.tree_util.tree_map(np.asarray, jax_ensemble([init, other]))
    toks = _tokens(4, seq=17)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    outs = {}
    for name, c, p in (("bf16", jcfg, init), ("fp32", jcfg32, _up(init))):
        outs[name] = jax.jit(jax_steps.make_train_step(
            c, jax_sgd(momentum=0.9), kd_mode="teacher", **STEP))(
            p, teacher, jax_sgd(momentum=0.9).init(p),
            jax.tree_util.tree_map(jnp.asarray, batch))
    cfg = _deepseek_options(get_smoke_config(ARCH)).replace(**BF16)
    teacher_port = ensemble_average([bridge.params_from_numpy(init),
                                     bridge.params_from_numpy(other)])
    assert_dtypes_equal(teacher_port, teacher, "the teacher")
    opt = sgd(momentum=0.9)
    params = bridge.params_from_numpy(init)
    new, state, m = steps.make_train_step(cfg, opt, kd_mode="teacher",
                                          **STEP)(
        params, teacher_port, opt.init(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    (jp, jo, jm), (jp32, jo32, jm32) = outs["bf16"], outs["fp32"]
    for k in ("loss", "ce", "kd", "aux", "mtp_ce"):
        assert_bf16_parity(f"metric {k}", m[k], jm[k], jm32[k])
    assert_bf16_parity("params after the step", new, jp, jp32)
    assert_bf16_parity("momentum (the gradients)", state, jo, jo32)


# ---------------------------------------------------------------- decode

def _decode_spy(monkeypatch):
    """Counts the (token, choice) entries the port's dispatch drops."""
    dropped = []
    real = moe.dispatch_plan

    def spy(*a, **k):
        slot, keep = real(*a, **k)
        dropped.append(int((~keep).sum()))
        return slot, keep

    monkeypatch.setattr(moe, "dispatch_plan", spy)
    return dropped


# (variant, batch, capacity factor): the published capacity, and a decode
# batch of 4 at 0.5, one slot an expert, which drops tokens
DECODE_CASES = {"mixtral-b2": ("mixtral", 2, None),
                "deepseek-options-b2": ("deepseek-options", 2, None),
                "mixtral-b4-drops": ("mixtral", 4, 0.5)}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_step_and_caches_match_reference(case, monkeypatch):
    """A 6-token prompt then 4 greedy steps through both ``decode_step``s
    (each fed the reference's tokens): the logits at every step and every
    cache leaf after the last (the window's ring of 8 slots is passed)."""
    name, b, cf = DECODE_CASES[case]
    cfg, jcfg, init, _, _ = reference(name)
    if cf is not None:
        cfg = cfg.replace(moe=cfg.moe._replace(capacity_factor=cf))
        jcfg = jcfg.replace(moe=jcfg.moe._replace(capacity_factor=cf))
    jdecode = jax.jit(lambda p, t, c: jax_transformer.decode_step(
        p, jcfg, t, c))
    dropped = _decode_spy(monkeypatch)
    params = bridge.params_from_numpy(init)
    prompt = np.random.default_rng(3).integers(0, 503, (b, 6)).astype(
        np.int32)
    jcache = jax_transformer.init_cache(jcfg, b, 12, jnp.float32)
    cache = transformer.init_cache(cfg, b, 12, torch.float32)
    tok = None
    for i in range(10):
        tok = prompt[:, i:i + 1] if i < 6 else tok
        jl, jcache = jdecode(init, jnp.asarray(tok), jcache)
        with torch.no_grad():
            lg, cache = transformer.decode_step(params, cfg,
                                                torch.from_numpy(tok), cache)
        _close(f"logits at step {i}", lg.numpy(), jl)
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    assert sorted(cache) == sorted(jcache)
    for key in cache:
        mine = [cache[key]] if key == "pos" else list(cache[key])
        leaves = jax.tree_util.tree_leaves(jcache[key])
        assert [tuple(a.shape) for a in mine] == [x.shape for x in leaves]
        for a, x in zip(mine, leaves):
            _close(f"cache {key}", a.numpy(), x)
    assert cache["seg0"].k.shape[2] == 8       # the window's ring
    if cf is not None:
        assert sum(dropped) > 0, "no token was dropped at decode"


def test_serve_loop_tokens_equal_reference():
    """The serve CLI's traffic (8 requests of 4-12 tokens, waves of 4, 16
    generated) through both ``ServeLoop``s on the mixtral smoke config:
    the tokens and the decode steps equal."""
    cfg, jcfg, init, _, _ = reference("mixtral")
    prompts = serve.make_prompts(8, cfg.vocab_size, 12)
    want = jax_serve.ServeLoop(jcfg, init, 4, 29).run(prompts, 16)
    got = serve.ServeLoop(cfg, bridge.params_from_numpy(init), 4, 29).run(
        prompts, 16)
    assert got["outputs"] == want["outputs"]
    assert got["decode_steps"] == want["decode_steps"]


# ------------------------------------------------------------ trajectory

def test_run_serial_two_rounds_match_reference(monkeypatch):
    """Two FedGKD rounds of ``run_serial``, 2 clients x 1 step of 2 x 32
    tokens, from the reference's init: log(ppl) and the loss of each round
    relative to their size, and the params after round 2.  The
    reference's step is the train-step test's jitted one."""
    cfg, jcfg, init, _, jstep = reference("mixtral")
    run = dict(rounds=2, n_clients=2, batches_per_round=1, batch=2, seq=33,
               lr=STEP["lr"], gamma=STEP["gamma"], seed=0)
    monkeypatch.setattr(jax_transformer, "init", lambda key, c: init)
    monkeypatch.setattr(jax_train, "jax", _SharedStepJax(jstep))
    want = jax_train.run_serial(jcfg, algo="fedgkd", verbose=False, **run)
    monkeypatch.setattr(transformer, "init",
                        lambda gen, c: bridge.params_from_numpy(init))
    got = train.run_serial(cfg, algo="fedgkd", verbose=False, device="cpu",
                           **run)
    for g, w in zip(got["history"], want["history"], strict=True):
        _close("log(ppl)", math.log(g["ppl"]), math.log(w["ppl"]))
        _close("loss", g["loss"], w["loss"])
    # round 1's teacher is the init, which one local step starts from
    assert got["history"][1]["kd"] > 0
    _close_trees("params after round 2", got["params"], want["params"])


def test_entry_points_run_mixtral_on_the_cpu(capsys):
    """The trainer's CLI (serial and sharded) and the serve CLI take
    ``--arch mixtral-8x7b``; ``run_sharded`` over two CPU clients equals
    ``run_serial`` with two."""
    assert train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--rounds", "1", "--clients", "2",
                       "--batches-per-round", "1", "--batch", "2",
                       "--seq", "17"]) == 0
    assert train.main(["--arch", ARCH, "--smoke", "--sharded", "--device",
                       "cpu", "--rounds", "1", "--batches-per-round", "1",
                       "--batch", "2", "--seq", "17"]) == 0
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--requests",
                       "4", "--gen", "4"]) == 0
    assert "served 4 requests" in capsys.readouterr().out
    cfg = get_smoke_config(ARCH)
    kw = dict(rounds=1, batches_per_round=1, batch=2, seq=17, verbose=False)
    sharded = train.run_sharded(cfg, devices=["cpu"] * 2, **kw)
    serial = train.run_serial(cfg, n_clients=2, device="cpu", **kw)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(sharded["params"]), tree_leaves(serial["params"])))
