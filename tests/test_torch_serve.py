"""The port's LM serve path against the JAX package, on the CPU.

At the reference's smoke configs (d_model 128, vocab 503) of the six
ported architectures (phi4-mini-3.8b, minitron-4b, granite-34b,
internlm2-20b, zamba2-1.2b, mamba2-2.7b), from the reference's
initialisation loaded through the bridge, with tokens from numpy seeds.
Checked, within TOL = 1e-5 of max(1, max |reference|) (fp32, different
summation orders; the smoke logits reach ~90): 12 steps of decode
(``decode_step`` over ``init_cache``) against the reference's jitted
``decode_step``, greedy after a 4-token prompt, both fed the reference's
tokens; the port's decode against its own teacher-forced forward within
the reference's bar, 2e-3 (``tests/test_arch_smoke.py:79``); the
sliding-window ring buffer (mirroring ``:102`` and ``:125``) against
windowed attention at the reference's 2e-5, for rings of the window, 6
and 16 slots, and against the reference's decode; the KV cache's update
with and without a ring; ``mamba2_forward`` and the SSD scan from an
entering state, with gradients; ``make_prefill_step`` with both
``last_only`` values; ``ServeLoop.run`` token for token with the
reference's on the same params and prompts, ``decode_steps`` equal; and
the serve CLI on the CPU, and its refusal without a card.  One reference
init and one jitted decode per architecture are shared across the cases.
"""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.configs import phi4_mini_3_8b as jax_phi4  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base, get_smoke_config  # noqa: E402
from repro_torch.configs import phi4_mini_3_8b  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import attention, ssm, transformer  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
DECODE_TOL = 2e-3     # decode against forward: tests/test_arch_smoke.py:79
RING_TOL = 2e-5       # the ring buffer: tests/test_arch_smoke.py:125
ARCHS = ["phi4-mini-3.8b", "minitron-4b", "granite-34b", "internlm2-20b",
         "zamba2-1.2b", "mamba2-2.7b"]
PROMPT, STEPS = 4, 12


def _diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    err = _diff(got, want)
    assert err < tol * max(1.0, float(np.abs(want).max())), err


_REF: dict = {}


def reference(arch, jcfg=None):
    """(reference cfg, reference init as numpy, the reference's jitted
    decode step), made once per architecture (or config)."""
    key = arch if jcfg is None else (arch, jcfg)
    if key not in _REF:
        jcfg = jcfg or jax_get_smoke(arch)
        init = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jax_transformer.init(k, jcfg))(jax.random.PRNGKey(0)))
        decode = jax.jit(lambda p, t, c: jax_transformer.decode_step(
            p, jcfg, t, c))
        _REF[key] = (jcfg, init, decode)
    return _REF[key]


def _prompt(seed, batch=2, length=PROMPT, vocab=503):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, length)).astype(np.int32)


def _decode_both(cfg, jcfg, init, jdecode, prompt, steps, max_len):
    """Decode ``prompt`` then ``steps - len(prompt)`` greedy tokens in both
    packages, each fed the reference's tokens: (port logits, reference
    logits, the tokens fed), logits (B, steps, V)."""
    params = bridge.params_from_numpy(init)
    jcache = jax_transformer.init_cache(jcfg, prompt.shape[0], max_len,
                                        jnp.float32)
    cache = transformer.init_cache(cfg, prompt.shape[0], max_len,
                                   torch.float32)
    got, want, fed = [], [], []
    tok = None
    for i in range(steps):
        tok = prompt[:, i:i + 1] if i < prompt.shape[1] else tok
        fed.append(tok)
        jl, jcache = jdecode(init, jnp.asarray(tok), jcache)
        with torch.no_grad():
            lg, cache = transformer.decode_step(params, cfg,
                                                torch.from_numpy(tok), cache)
        got.append(lg[:, 0].numpy())
        want.append(np.asarray(jl)[:, 0])
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    return np.stack(got, 1), np.stack(want, 1), np.concatenate(fed, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_reference_and_forward(arch):
    cfg = get_smoke_config(arch)
    jcfg, init, jdecode = reference(arch)
    got, want, fed = _decode_both(cfg, jcfg, init, jdecode, _prompt(1),
                                  STEPS, 16)
    _close(got, want)
    with torch.no_grad():
        full, _ = transformer.forward(bridge.params_from_numpy(init), cfg,
                                      torch.from_numpy(fed))
    assert _diff(got, full.numpy()) < DECODE_TOL


def test_decode_caches_match_reference():
    """After the hybrid's 12 steps every cache leaf (KV caches of the shared
    block, conv and SSM states, lengths, ``pos``) equals the reference's."""
    arch = "zamba2-1.2b"
    cfg = get_smoke_config(arch)
    jcfg, init, jdecode = reference(arch)
    params = bridge.params_from_numpy(init)
    toks = _prompt(2, length=STEPS)
    jcache = jax_transformer.init_cache(jcfg, 2, 16, jnp.float32)
    cache = transformer.init_cache(cfg, 2, 16, torch.float32)
    for i in range(STEPS):
        _, jcache = jdecode(init, jnp.asarray(toks[:, i:i + 1]), jcache)
        with torch.no_grad():
            _, cache = transformer.decode_step(
                params, cfg, torch.from_numpy(toks[:, i:i + 1]), cache)
    assert sorted(cache) == sorted(jcache) == ["pos", "seg0", "shared"]
    for key in cache:
        leaves = jax.tree_util.tree_leaves(jcache[key])
        mine = [cache[key]] if key == "pos" else list(cache[key])
        assert len(mine) == len(leaves)
        for a, b in zip(mine, leaves):
            assert tuple(a.shape) == b.shape
            _close(a.numpy(), b)


# ------------------------------------------------------------ ring buffer

@pytest.mark.parametrize("ring", [4, 6, 16])
def test_ring_buffer_decode_matches_windowed_attention(ring):
    """``gqa_decode_step`` with window 4 over rings of the window, 6 and 16
    slots against the windowed full attention (the reference's 2e-5), and
    against the reference's ring decode."""
    d_model, n_heads, n_kv, hd, window = 32, 4, 2, 8, 4
    p = jax.tree_util.tree_map(np.asarray, jax_attention.gqa_init(
        jax.random.PRNGKey(0), d_model, n_heads, n_kv, hd))
    x = np.array(jax.random.normal(jax.random.PRNGKey(2), (1, 10, d_model)))
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd, window=window)
    params = bridge.params_from_numpy(p)
    full = attention.gqa_attention(params, torch.from_numpy(x),
                                   positions=torch.arange(10)[None], **kw)
    cache = attention.kv_cache_init(1, ring, n_kv, hd, torch.float32)
    jcache = jax_attention.kv_cache_init(1, ring, n_kv, hd, jnp.float32)
    got, want = [], []
    for i in range(10):
        y, cache = attention.gqa_decode_step(
            params, torch.from_numpy(x[:, i:i + 1]), cache, **kw)
        jy, jcache = jax_attention.gqa_decode_step(
            p, jnp.asarray(x[:, i:i + 1]), jcache, **kw)
        got.append(y[:, 0].numpy())
        want.append(np.asarray(jy)[:, 0])
    got = np.stack(got, 1)
    assert _diff(got, full.numpy()) < RING_TOL
    _close(got, np.stack(want, 1))
    assert int(cache.length) == int(jcache.length) == 10


def test_sliding_window_model_decode_matches_reference():
    """phi4-mini's long variant at the smoke size (window 8) over 12
    tokens: the ring of 8 slots that ``init_cache`` makes, against the
    reference's decode and against the windowed forward."""
    jcfg = jax_get_smoke("phi4-mini-3.8b").replace(
        attn_window=min(jax_phi4.long_variant().attn_window, 8))
    cfg = base.reduce_for_smoke(phi4_mini_3_8b.long_variant())
    assert cfg.attn_window == jcfg.attn_window == 8
    _, init, jdecode = reference("phi4-mini-3.8b", jcfg)
    got, want, fed = _decode_both(cfg, jcfg, init, jdecode,
                                  _prompt(3, length=12), 12, 64)
    assert transformer.init_cache(cfg, 1, 64)["seg0"].k.shape[2] == 8
    _close(got, want)
    with torch.no_grad():
        full, _ = transformer.forward(bridge.params_from_numpy(init), cfg,
                                      torch.from_numpy(fed))
    assert _diff(got, full.numpy()) < DECODE_TOL


@pytest.mark.parametrize("ring", [False, True])
def test_kv_cache_update_matches_reference(ring):
    """Two tokens at a time into 5 slots: the ring wraps, the plain cache
    clamps its start as ``lax.dynamic_update_slice`` does."""
    rng = np.random.default_rng(5)
    cache = attention.kv_cache_init(1, 5, 2, 3, torch.float32)
    jcache = jax_attention.kv_cache_init(1, 5, 2, 3, jnp.float32)
    for _ in range(4):
        k, v = (rng.standard_normal((1, 2, 2, 3)).astype(np.float32)
                for _ in range(2))
        cache = attention.kv_cache_update(cache, torch.from_numpy(k),
                                          torch.from_numpy(v), ring=ring)
        jcache = jax_attention.kv_cache_update(jcache, jnp.asarray(k),
                                               jnp.asarray(v), ring=ring)
        for a, b in zip(cache, jcache):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bf16_caches_raise_naming_a15_3():
    """bf16 caches are ported (ROADMAP A15.3): each cache initialiser's
    default dtype and leaves, leaf for leaf, are the reference's."""
    kv, jkv = attention.kv_cache_init(1, 4, 2, 8), \
        jax_attention.kv_cache_init(1, 4, 2, 8)
    scfg = get_smoke_config("mamba2-2.7b").ssm
    sc, jsc = (ssm.ssm_cache_init(1, scfg, dtype=torch.bfloat16),
               jax_ssm.ssm_cache_init(1, jax_get_smoke("mamba2-2.7b").ssm,
                                      jnp.bfloat16))
    for a, b in zip(tuple(kv) + tuple(sc), tuple(jkv) + tuple(jsc)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert tuple(a.shape) == b.shape and not a.any()


# ----------------------------------------------------- SSD entering state

def test_mamba2_forward_from_an_entering_state():
    cfg = get_smoke_config("mamba2-2.7b")
    jcfg, init, _ = reference("mamba2-2.7b")
    p = jax.tree_util.tree_map(lambda a: a[0], init["seg0"]["mixer"])
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 39, 128)).astype(np.float32)
    s0 = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
    with torch.no_grad():
        y, final = ssm.mamba2_forward(bridge.params_from_numpy(p),
                                      torch.from_numpy(x), cfg.ssm,
                                      init_state=torch.from_numpy(s0))
    jy, jfinal = jax.jit(lambda p, x, s: jax_ssm.mamba2_forward(
        p, x, jcfg.ssm, init_state=s))(p, jnp.asarray(x), jnp.asarray(s0))
    _close(y.numpy(), jy)
    _close(final.numpy(), jfinal)


def test_ssd_scan_from_an_entering_state_and_its_gradients():
    """``ops.ssd_scan(init_state=)`` (the plain version on the CPU) against
    the reference's ``ssd_chunked``: outputs, and the gradients of all six
    inputs, the entering state's included."""
    rng = np.random.default_rng(7)
    b, l, h, p, g, n, chunk = 2, 21, 4, 8, 2, 8, 8
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)))) * 0.1).astype(
        np.float32)
    A = -np.arange(1, h + 1, dtype=np.float32)
    B, C = (rng.standard_normal((b, l, g, n)).astype(np.float32)
            for _ in range(2))
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    wy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    ws = rng.standard_normal((b, h, p, n)).astype(np.float32)
    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in (x, dt, A, B, C, s0)]
    y, s = ssd_ops.ssd_scan(*ins[:5], chunk=chunk, init_state=ins[5])
    ((y * torch.from_numpy(wy)).sum() + (s * torch.from_numpy(ws)).sum()
     ).backward()

    def loss(x, dt, A, B, C, s0):
        y, s = jax_ssm.ssd_chunked(x, dt, A, B, C, chunk, init_state=s0)
        return jnp.sum(y * wy) + jnp.sum(s * ws), (y, s)

    (_, (jy, js)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(6)), has_aux=True)(
        *(jnp.asarray(a) for a in (x, dt, A, B, C, s0)))
    _close(y.detach().numpy(), jy)
    _close(s.detach().numpy(), js)
    for t, want in zip(ins, grads):
        _close(t.grad.numpy(), want)


# ---------------------------------------------------------------- prefill

@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "zamba2-1.2b"])
@pytest.mark.parametrize("last_only", [True, False])
def test_prefill_step_matches_reference(arch, last_only):
    cfg = get_smoke_config(arch)
    jcfg, init, _ = reference(arch)
    toks = _prompt(8, length=17)
    want = jax.jit(jax_steps.make_prefill_step(jcfg, last_only=last_only))(
        init, {"tokens": jnp.asarray(toks)})
    got = steps.make_prefill_step(cfg, last_only=last_only)(
        bridge.params_from_numpy(init), {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == want.shape == (2, 1 if last_only else 17, 503)
    assert not got.requires_grad
    _close(got.numpy(), want)


def test_serve_step_matches_reference():
    cfg = get_smoke_config("granite-34b")
    jcfg, init, _ = reference("granite-34b")
    tok = _prompt(9, length=1)
    jl, _ = jax_steps.make_serve_step(jcfg)(
        init, jax_transformer.init_cache(jcfg, 2, 4, jnp.float32),
        jnp.asarray(tok))
    lg, cache = steps.make_serve_step(cfg)(
        bridge.params_from_numpy(init),
        transformer.init_cache(cfg, 2, 4, torch.float32),
        torch.from_numpy(tok))
    _close(lg.numpy(), jl)
    assert int(cache["pos"]) == 1


# -------------------------------------------------------------- ServeLoop

@pytest.mark.parametrize("arch", ["zamba2-1.2b", "phi4-mini-3.8b"])
def test_serve_loop_matches_reference(arch):
    """The CLI's traffic (8 requests of 4-12 tokens from ``default_rng(0)``,
    waves of 4, 16 generated) through both ``ServeLoop``s from the same
    params: the outputs token for token, the decode steps equal."""
    cfg = get_smoke_config(arch)
    jcfg, init, _ = reference(arch)
    prompts = serve.make_prompts(8, cfg.vocab_size, 12)
    rng = np.random.default_rng(0)
    jprompts = [rng.integers(0, jcfg.vocab_size, size=rng.integers(4, 13))
                .astype(np.int32) for _ in range(8)]
    assert all(np.array_equal(a, b) for a, b in zip(prompts, jprompts))
    want = jax_serve.ServeLoop(jcfg, init, 4, 29).run(jprompts, 16)
    got = serve.ServeLoop(cfg, bridge.params_from_numpy(init), 4, 29).run(
        prompts, 16)
    assert got["outputs"] == want["outputs"]
    assert got["decode_steps"] == want["decode_steps"]
    assert got["tok_per_s"] > 0 and math.isfinite(got["seconds"])


def test_serve_cli_runs_on_the_cpu_and_raises_without_a_card(monkeypatch,
                                                            capsys):
    assert serve.main(["--device", "cpu"]) == 0
    assert "served 8 requests" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main([])
