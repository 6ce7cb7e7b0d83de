"""The port's MLA and deepseek-v3 against the JAX package, on the CPU.

``models.attention``'s MLA (``mla_attention``, the prefill and training
form that makes every head's keys and values from the latent, and
``mla_decode_step``, the absorbed form over the compressed cache), the
model stack with MLA layers, and deepseek-v3-671b's smoke config (MLA of 4
heads, kv rank 16; one dense layer, then one MoE layer of 4 experts with a
sigmoid router and a shared expert; the MTP head; vocab 503) through the
forward, the FedGKD step (its MTP term included), decode and
``ServeLoop``; the same config at one layer, where the MoE run is empty
(leaves with a leading axis of 0, as the reference builds them).  Weights
are the reference's initialisation loaded through the bridge; inputs come
from numpy seeds.

Tolerance, stated before any comparison: TOL = 1e-5 of the compared
value's largest magnitude (or absolute where that is below 1): fp32 in
both packages, different summation orders.  Decode against prefill is
held at the reference's own bar for it (``tests/test_models_units.py``:
rtol 1e-3, atol 1e-4).  The bf16 step is held as ``tests/test_torch_bf16.py``
holds the other families: no further from the reference's fp32 run than
twice the reference's bf16 run, or one bf16 ulp.  Token outputs (greedy
decode, ``ServeLoop``) are equal.

The reference runs jitted, each function compiled once and shared across
the cases.
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
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import lm_token_batches  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402
from test_torch_bf16 import (BF16, FP32, _up,  # noqa: E402
                             assert_bf16_parity, assert_dtypes_equal)
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
PREFILL_RTOL, PREFILL_ATOL = 1e-3, 1e-4   # tests/test_models_units.py:88
ARCH = "deepseek-v3-671b"
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


def _tokens(seed, batch=2, seq=17):
    return lm_token_batches(np.random.default_rng(seed), batch, seq, 503)


_REF: dict = {}


def reference(n_layers=2):
    """(port cfg, reference cfg, the reference's init as numpy, its jitted
    forward, its jitted decode step), once per depth of the smoke
    config."""
    if n_layers not in _REF:
        jcfg = jax_get_smoke(ARCH).replace(n_layers=n_layers)
        init = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jax_transformer.init(k, jcfg))(jax.random.PRNGKey(0)))
        fwd = jax.jit(lambda p, t: jax_transformer.forward(p, jcfg, t))
        decode = jax.jit(lambda p, t, c: jax_transformer.decode_step(
            p, jcfg, t, c))
        _REF[n_layers] = (get_smoke_config(ARCH).replace(n_layers=n_layers),
                          jcfg, init, fwd, decode)
    return _REF[n_layers]


# ------------------------------------------------------------------- MLA

MLA = dict(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
           qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
_LAYER: dict = {}


def mla_layer():
    """(port MLAConfig, reference MLAConfig, the reference's params as
    numpy, x (2, 9, 64)): the reference's unit-test geometry."""
    if not _LAYER:
        jcfg = jax_attention.MLAConfig(**MLA)
        p = jax.tree_util.tree_map(np.asarray, jax_attention.mla_init(
            jax.random.PRNGKey(0), jcfg))
        x = np.random.default_rng(1).standard_normal((2, 9, 64)).astype(
            np.float32)
        _LAYER["ref"] = (attention.MLAConfig(**MLA), jcfg, p, x)
    return _LAYER["ref"]


def _positions(b, s):
    return np.broadcast_to(np.arange(s)[None], (b, s))


def test_mla_config_and_init_have_the_references_fields_and_shapes():
    cfg, jcfg, p, _ = mla_layer()
    assert cfg._fields == jcfg._fields and tuple(cfg) == tuple(jcfg)
    assert attention.MLAConfig(64, 4) == tuple(jax_attention.MLAConfig(64, 4))
    mine = attention.mla_init(torch.Generator().manual_seed(0), cfg)
    assert ({k: tuple(v.shape) for k, v in tree_paths(mine)}
            == {k: np.shape(v) for k, v in tree_paths(p)})


def test_mla_attention_matches_reference():
    """Causal MLA over 9 positions, and its gradients with respect to x
    and every weight."""
    cfg, jcfg, p, x = mla_layer()
    pos = _positions(2, 9)

    def jloss(params, x):
        y = jax_attention.mla_attention(params, x, jcfg, pos)
        return jnp.sum(y * jnp.sin(y))

    want = jax.jit(lambda params, x: jax_attention.mla_attention(
        params, x, jcfg, pos))(p, x)
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, x)
    params = bridge.params_from_numpy(p)
    leaves = tree_leaves(params)
    xt = torch.from_numpy(x).requires_grad_(True)
    for t in leaves:
        t.requires_grad_(True)
    y = attention.mla_attention(params, xt, cfg, torch.from_numpy(pos.copy()))
    _close("mla_attention", y.detach().numpy(), want)
    torch.sum(y * torch.sin(y)).backward()
    _close_trees("the weights' gradients", [t.grad for t in leaves],
                 jgrads[0])
    _close("x's gradient", xt.grad.numpy(), jgrads[1])


def test_mla_decode_step_matches_reference_step_by_step():
    """Nine one-token steps of the absorbed form into a cache of 12 slots:
    every step's output and the cache after it (latent, RoPE key,
    length)."""
    cfg, jcfg, p, x = mla_layer()
    jstep = jax.jit(lambda c, t: jax_attention.mla_decode_step(p, t, c, jcfg))
    jcache = jax_attention.mla_cache_init(2, 12, jcfg, jnp.float32)
    cache = attention.mla_cache_init(2, 12, cfg, torch.float32)
    params = bridge.params_from_numpy(p)
    for i in range(9):
        jy, jcache = jstep(jcache, x[:, i:i + 1])
        y, cache = attention.mla_decode_step(
            params, torch.from_numpy(x[:, i:i + 1]), cache, cfg)
        _close(f"y at step {i}", y.numpy(), jy)
        for name, a, w in zip(cache._fields, cache, jcache):
            _close(f"cache {name} at step {i}", a.numpy(), w)
    assert int(cache.length) == 9 and cache.c_kv.dtype == torch.float32


def test_mla_decode_matches_prefill():
    """The absorbed decode against the prefill form over the same tokens,
    at the reference's own bar (``test_mla_decode_matches_prefill``)."""
    cfg, _, p, x = mla_layer()
    params = bridge.params_from_numpy(p)
    full = attention.mla_attention(params, torch.from_numpy(x), cfg,
                                   torch.from_numpy(_positions(2, 9).copy()))
    cache = attention.mla_cache_init(2, 12, cfg, torch.float32)
    outs = []
    for i in range(9):
        y, cache = attention.mla_decode_step(
            params, torch.from_numpy(x[:, i:i + 1]), cache, cfg)
        outs.append(y[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=PREFILL_RTOL, atol=PREFILL_ATOL)


def test_mla_bf16_matches_reference():
    """MLA in bf16 (weights and x).  Prefill at ``test_torch_bf16.py``'s bar
    against the reference's bf16 and fp32 runs.  The reference's bf16
    decode does not run on this JAX's CPU backend (``out_lat`` (bf16)
    against ``w_v`` (bf16) into fp32 is an unimplemented dot there; ROADMAP
    C), so nine decode steps over a bf16 cache are held to the reference's
    fp32 decode from the same values upcast, under the same bar with the
    reference's bf16 distance taken from its prefill of the same layer."""
    cfg, jcfg, p, x = mla_layer()
    pos = _positions(2, 9)
    p16 = jax.tree_util.tree_map(lambda a: np.asarray(
        jnp.asarray(a, jnp.bfloat16)), p)
    x16 = np.asarray(jnp.asarray(x, jnp.bfloat16))
    prefill = jax.jit(lambda a, b: jax_attention.mla_attention(a, b, jcfg,
                                                               pos))

    def decode32(params, x):
        c = jax_attention.mla_cache_init(2, 9, jcfg, jnp.float32)
        outs = []
        for i in range(9):
            y, c = jax_attention.mla_decode_step(params, x[:, i:i + 1], c,
                                                 jcfg)
            outs.append(y)
        return jnp.concatenate(outs, 1)

    want, want32 = prefill(p16, x16), prefill(_up(p16), _up(x16))
    dec32 = np.asarray(jax.jit(decode32)(_up(p16), _up(x16)))
    params = bridge.params_from_numpy(p16)
    xt = bridge.array_to_tensor(x16)
    y = attention.mla_attention(params, xt, cfg, torch.from_numpy(pos.copy()))
    assert_bf16_parity("MLA prefill in bf16", y, want, want32)
    cache = attention.mla_cache_init(2, 9, cfg)
    outs = []
    for i in range(9):
        yd, cache = attention.mla_decode_step(params, xt[:, i:i + 1], cache,
                                              cfg)
        outs.append(yd)
    dec = torch.cat(outs, 1)
    assert dec.dtype == cache.c_kv.dtype == torch.bfloat16
    e_ref = _diff(np.asarray(want, np.float32), want32)
    bar = max(2 * e_ref, 2.0 ** -8 * float(np.abs(dec32).max()))
    e_port = _diff(dec.float().numpy(), dec32)
    assert e_port <= bar, f"bf16 decode {e_port:.3e} from fp32, bar {bar:.3e}"


# ----------------------------------------------------------- deepseek-v3

def test_deepseek_config_fields_equal_reference():
    for get, jget in ((get_smoke_config, jax_get_smoke),
                      (get_config, jax_get_config)):
        cfg, jcfg = get(ARCH), jget(ARCH)
        for f in dataclasses.fields(cfg):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            if f.name in ("mla", "moe"):
                got, want = tuple(got), tuple(want)
            assert got == want, f.name
        assert cfg.segments() == jcfg.segments()
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
    assert get_config(ARCH).param_count() == 671_712_535_552


def test_deepseek_forward_matches_reference():
    cfg, _, init, fwd, _ = reference()
    toks = _tokens(2)[:, :-1]
    want, want_aux = fwd(init, toks)
    with torch.no_grad():
        got, aux = transformer.forward(bridge.params_from_numpy(init), cfg,
                                       torch.from_numpy(toks))
    _close("logits", got.numpy(), want)
    _close("aux", float(aux), float(want_aux))
    assert float(aux) > 0


def test_deepseek_fedgkd_step_matches_reference():
    """One FedGKD step (a teacher that disagrees with the student): the
    loss and its terms (CE, KD, the load-balance aux, the MTP CE), the
    params after."""
    cfg, jcfg, init, _, _ = reference()
    rng = np.random.default_rng(4)
    teacher = jax.tree_util.tree_map(
        lambda a: (a + 0.5 * rng.standard_normal(a.shape)).astype(a.dtype),
        init)
    toks = _tokens(5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jp, _, jm = jax.jit(jax_steps.make_train_step(
        jcfg, jax_sgd(momentum=0.9), kd_mode="teacher", **STEP))(
        init, teacher, jax_sgd(momentum=0.9).init(init),
        jax.tree_util.tree_map(jnp.asarray, batch))
    opt = sgd(momentum=0.9)
    params = bridge.params_from_numpy(init)
    new, _, m = steps.make_train_step(cfg, opt, kd_mode="teacher", **STEP)(
        params, bridge.params_from_numpy(teacher), opt.init(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    keys = ["loss", "ce", "kd", "aux", "mtp_ce"]
    assert sorted(m) == sorted(keys) == sorted(jm)
    for k in keys:
        _close(k, float(m[k]), float(jm[k]))
    assert float(m["kd"]) > 0 and float(m["mtp_ce"]) > 0
    _close_trees("params after the step", new, jp)


def test_deepseek_decode_and_mla_caches_match_reference():
    """A 6-token prompt and 4 greedy steps through both ``decode_step``s
    (each fed the reference's tokens): the logits at every step and every
    cache leaf after the last (MLA's latent and RoPE key a layer)."""
    cfg, jcfg, init, _, jdecode = reference()
    params = bridge.params_from_numpy(init)
    prompt = np.random.default_rng(3).integers(0, 503, (2, 6)).astype(
        np.int32)
    jcache = jax_transformer.init_cache(jcfg, 2, 12, jnp.float32)
    cache = transformer.init_cache(cfg, 2, 12, torch.float32)
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
    assert isinstance(cache["seg0"], attention.MLACache)
    assert tuple(cache["seg0"].c_kv.shape) == (1, 2, 12, 16)


def test_deepseek_serve_loop_tokens_equal_reference():
    """The serve CLI's traffic (8 requests of 4-12 tokens, waves of 4, 16
    generated) through both ``ServeLoop``s: the tokens and the decode
    steps equal."""
    cfg, jcfg, init, _, _ = reference()
    prompts = serve.make_prompts(8, cfg.vocab_size, 12)
    want = jax_serve.ServeLoop(jcfg, init, 4, 29).run(prompts, 16)
    got = serve.ServeLoop(cfg, bridge.params_from_numpy(init), 4, 29).run(
        prompts, 16)
    assert got["outputs"] == want["outputs"]
    assert got["decode_steps"] == want["decode_steps"]


def test_empty_moe_run_at_one_layer_matches_reference():
    """deepseek at one layer: ``segments()`` gives a MoE run of 0 layers,
    whose leaves the reference stacks with a leading axis of 0.  The port's
    init has the reference's tree, shapes and dtypes; the bridge carries
    the empty leaves both ways; the forward and greedy decode (its empty
    run's cache left as it was) match the reference's; a train step keeps
    the empty leaves empty."""
    cfg, jcfg, init, fwd, jdecode = reference(1)
    assert cfg.segments() == jcfg.segments() == [("dense", 1), ("moe", 0)]
    mine = transformer.init(torch.Generator().manual_seed(0), cfg)
    got = {k: tuple(v.shape) for k, v in tree_paths(mine)}
    want = {k: np.shape(v) for k, v in tree_paths(init)}
    assert got == want
    empty = [k for k, s in want.items() if k[0] == "seg1"]
    assert empty and all(want[k][0] == 0 for k in empty)
    assert_dtypes_equal(mine, init, "init")
    params = bridge.params_from_numpy(init)
    back = bridge.params_to_numpy(params)
    assert all(np.shape(a) == np.shape(b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(init)))
    toks = _tokens(6)
    want_logits, _ = fwd(init, toks[:, :-1])
    with torch.no_grad():
        logits, aux = transformer.forward(params, cfg,
                                          torch.from_numpy(toks[:, :-1]))
    _close("logits", logits.numpy(), want_logits)
    assert float(aux) == 0.0
    jcache = jax_transformer.init_cache(jcfg, 2, 4, jnp.float32)
    cache = transformer.init_cache(cfg, 2, 4, torch.float32)
    for i in range(4):
        jl, jcache = jdecode(init, jnp.asarray(toks[:, i:i + 1]), jcache)
        with torch.no_grad():
            lg, cache = transformer.decode_step(
                params, cfg, torch.from_numpy(toks[:, i:i + 1]), cache)
        _close(f"decode logits at step {i}", lg.numpy(), jl)
    assert tuple(cache["seg1"].c_kv.shape) == (0, 2, 4, 16)
    opt = sgd(momentum=0.9)
    new, _, m = steps.make_train_step(cfg, opt, kd_mode="none", **STEP)(
        params, (), opt.init(params),
        {"tokens": torch.from_numpy(toks[:, :-1]),
         "labels": torch.from_numpy(toks[:, 1:])})
    assert np.isfinite(float(m["loss"])) and float(m["mtp_ce"]) > 0
    assert all(t.shape[0] == 0 for t in tree_leaves(new["seg1"]))


def test_deepseek_bf16_fedgkd_step_matches_reference():
    """One FedGKD step of the smoke config in bf16 (the routers fp32; MLA;
    the MTP head) from a zero momentum and a teacher that is the mean of
    two inits: the loss terms, the params after and the momentum (the
    gradients), dtypes leaf for leaf."""
    from repro.core.distillation import ensemble_average as jax_ensemble
    from repro_torch.core.distillation import ensemble_average

    _, jcfg, _, _, _ = reference()
    jcfg = jcfg.replace(**BF16)
    init_fn = jax.jit(lambda k: jax_transformer.init(k, jcfg))
    init, other = (jax.tree_util.tree_map(np.asarray,
                                          init_fn(jax.random.PRNGKey(i)))
                   for i in (0, 5))
    teacher = jax.tree_util.tree_map(np.asarray, jax_ensemble([init, other]))
    toks = _tokens(4)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    outs = {}
    for name, c, p in (("bf16", jcfg, init),
                       ("fp32", jcfg.replace(**FP32), _up(init))):
        outs[name] = jax.jit(jax_steps.make_train_step(
            c, jax_sgd(momentum=0.9), kd_mode="teacher", **STEP))(
            p, teacher, jax_sgd(momentum=0.9).init(p),
            jax.tree_util.tree_map(jnp.asarray, batch))
    cfg = get_smoke_config(ARCH).replace(**BF16)
    teacher_port = ensemble_average([bridge.params_from_numpy(init),
                                     bridge.params_from_numpy(other)])
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


def test_train_and_serve_entry_points_run_deepseek_on_the_cpu(capsys):
    assert train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--rounds", "1", "--clients", "2",
                       "--batches-per-round", "1", "--batch", "2",
                       "--seq", "17"]) == 0
    from repro_torch.launch import serve as serve_cli
    assert serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests",
                           "2", "--gen", "3"]) == 0
    assert "served 2 requests" in capsys.readouterr().out
