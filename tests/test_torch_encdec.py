"""The port's encoder-decoder and frontend models against the JAX package.

seamless-m4t-large-v2's smoke config (an encoder of 2 bidirectional
layers over 16 frontend frames, 2 decoder layers with cross-attention;
LayerNorm, GELU, a tied head, d_model 128, vocab 503) through ``encode``,
the forward with the encoder's output, ``decode_step(enc_out=)`` and the
last-position prefill; llava-next-34b's (16 patch embeddings before the
text, RMSNorm, SwiGLU, an untied head) through the prefix forward and the
text-only CE (``text_offset``); both through one FedGKD step, in fp32 and
in bf16, and through a step of the ``cached_topk`` KD mode (the teacher's
top-K logits, ``kd_topk_kl``).  Also the frontends' geometries and the
flash wrapper's cross-attention form (Sq != Skv, no mask) against the reference's Pallas
kernel in interpret mode.  Weights are the reference's initialisation
loaded through the bridge; tokens and embeddings come from numpy seeds
and go to both packages.

Tolerance, stated before any comparison: TOL = 1e-5 of the compared
value's largest magnitude (or absolute where that is below 1): fp32 in
both packages, different summation orders.  The bf16 steps are held as
``tests/test_torch_bf16.py`` holds the other families: no further from
the reference's fp32 run than twice the reference's bf16 run (compiled to
round as written), or one bf16 ulp.  Greedy tokens are equal.

The reference runs jitted, each function compiled once per config and
shared across the cases.
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
from repro.kernels.flash_attention import ops as jax_fa_ops  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import frontends as jax_frontends  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import lm_token_batches  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import frontends, transformer  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_bf16 import (BF16, FP32, _rounding_as_written,  # noqa: E402
                             _up, assert_bf16_parity)
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
SEAMLESS, LLAVA = "seamless-m4t-large-v2", "llava-next-34b"
STEP = dict(gamma=0.2, lr=0.1)
FRONT = frontends.SMOKE_FRONTEND_SEQ
TOPK = 64


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


def _embeddings(seed, batch=2, seq=FRONT, d=128):
    """Unit-RMS stand-ins for a frontend's output, made with numpy."""
    x = np.random.default_rng(seed).standard_normal((batch, seq, d))
    return (x / np.sqrt(np.mean(x * x, -1, keepdims=True) + 1e-6)).astype(
        np.float32)


def _batch(arch, seed, seq=13):
    """A train batch of the arch's smoke config: tokens and labels (2,
    seq - 1) and its frontend embeddings (2, 16, 128)."""
    toks = lm_token_batches(np.random.default_rng(seed), 2, seq, 503)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    key = "enc_embeddings" if arch == SEAMLESS else "frontend_embeddings"
    batch[key] = _embeddings(seed + 100)
    return batch


def _topk(batch, seed, k=TOPK):
    """The batch with a teacher's top-k logits and their ids at every text
    position, from random logits."""
    logits = np.random.default_rng(seed).standard_normal(
        batch["labels"].shape + (503,)).astype(np.float32) * 3
    idx = np.argsort(-logits, axis=-1, kind="stable")[..., :k]
    return {**batch, "teacher_topk_idx": idx.astype(np.int32),
            "teacher_topk_vals": np.take_along_axis(logits, idx, -1)}


def _jnp(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


_REF: dict = {}


def reference(arch):
    """(port cfg, reference cfg, the reference's init as numpy), once per
    architecture."""
    if arch not in _REF:
        jcfg = jax_get_smoke(arch)
        init = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jax_transformer.init(k, jcfg))(jax.random.PRNGKey(0)))
        _REF[arch] = (get_smoke_config(arch), jcfg, init)
    return _REF[arch]


_JIT: dict = {}


def jitted(name, arch):
    """The reference's jitted functions of the arch's smoke config, each
    compiled once."""
    if (name, arch) not in _JIT:
        _, jcfg, _ = reference(arch)
        fns = {
            "encode": lambda: jax.jit(lambda p, e: jax_transformer.encode(
                p, jcfg, e)),
            "forward": lambda: jax.jit(
                lambda p, t, kw: jax_transformer.forward(p, jcfg, t, **kw)),
            "decode": lambda: jax.jit(lambda p, t, c, e: jax_transformer
                                      .decode_step(p, jcfg, t, c,
                                                   enc_out=e)),
            "teacher": lambda: jax.jit(jax_steps.make_train_step(
                jcfg, jax_sgd(momentum=0.9), kd_mode="teacher", **STEP)),
            "cached_topk": lambda: jax.jit(jax_steps.make_train_step(
                jcfg, jax_sgd(momentum=0.9), kd_mode="cached_topk", **STEP)),
        }
        _JIT[(name, arch)] = fns[name]()
    return _JIT[(name, arch)]


# ------------------------------------------------------- configs, inputs

def test_frontend_geometries_equal_reference():
    assert (frontends.AUDIO_FRAMES, frontends.VLM_PATCHES) == (
        jax_frontends.AUDIO_FRAMES, jax_frontends.VLM_PATCHES) == (384, 576)
    for f in ("audio", "vision"):
        assert frontends.frontend_seq(f) == jax_frontends.frontend_seq(f)
        assert frontends.SMOKE_FRONTEND_SEQ == \
            jax_frontends.frontend_seq(f, smoke=True)
    for arch in (SEAMLESS, LLAVA):
        assert get_smoke_config(arch).frontend_seq == \
            frontends.SMOKE_FRONTEND_SEQ == jax_get_smoke(arch).frontend_seq
    e = frontends.synth_embeddings(torch.Generator().manual_seed(0), 2, 5,
                                   64, torch.bfloat16)
    assert tuple(e.shape) == (2, 5, 64) and e.dtype == torch.bfloat16
    rms = torch.sqrt(torch.mean(e.float() ** 2, -1))
    assert float((rms - 1).abs().max()) < 1e-2


@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_config_fields_and_counts_equal_reference(arch):
    for get, jget in ((get_smoke_config, jax_get_smoke),
                      (get_config, jax_get_config)):
        cfg, jcfg = get(arch), jget(arch)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.segments() == jcfg.segments()
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
    cfg, _, init = reference(arch)
    mine = transformer.init(torch.Generator().manual_seed(0), cfg)
    assert ([tuple(t.shape) for t in tree_leaves(mine)]
            == [np.shape(a) for a in jax.tree_util.tree_leaves(init)])


def test_cross_attention_plain_version_matches_reference_kernel():
    """The flash wrapper's non-causal form with Sq != Skv (the decoder's
    queries against 128 encoder positions, GQA 4/2), against the
    reference's Pallas kernel in interpret mode (its Skv a multiple of
    its 128-key block, so the kernel runs), and the gradients against its
    custom VJP's."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 128, 2, 32)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jax_fa_ops.flash_attention_gqa(q, k, v, causal=False)
                       * g)

    want = jax.jit(lambda q, k, v: jax_fa_ops.flash_attention_gqa(
        q, k, v, causal=False))(q, k, v)
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fa_ops.flash_attention_gqa(qt, kt, vt, causal=False)
    _close("non-causal cross attention", out.detach().numpy(), want)
    (out * torch.from_numpy(g)).sum().backward()
    for name, t, w in zip("qkv", (qt, kt, vt), jgrads):
        _close(f"d{name}", t.grad.numpy(), w)


# --------------------------------------------------------- enc-dec model

def _encoded(seed=1):
    cfg, _, init = reference(SEAMLESS)
    e = _embeddings(seed)
    want = jitted("encode", SEAMLESS)(init, e)
    got = transformer.encode(bridge.params_from_numpy(init), cfg,
                             torch.from_numpy(e))
    return got, want


def test_encode_matches_reference():
    got, want = _encoded()
    assert tuple(got.shape) == (2, FRONT, 128)
    _close("encoder output", got.detach().numpy(), want)


def test_forward_with_enc_out_matches_reference():
    cfg, _, init = reference(SEAMLESS)
    enc, jenc = _encoded()
    toks = lm_token_batches(np.random.default_rng(2), 2, 12, 503)
    want, _ = jitted("forward", SEAMLESS)(init, toks, {"enc_out": jenc})
    with torch.no_grad():
        got, aux = transformer.forward(bridge.params_from_numpy(init), cfg,
                                       torch.from_numpy(toks), enc_out=enc)
    assert tuple(got.shape) == (2, 12, 503) and float(aux) == 0.0
    _close("logits", got.numpy(), want)


def test_decode_with_enc_out_matches_reference():
    """A 5-token prompt then 5 greedy steps through both ``decode_step``s
    with the encoder's output (each fed the reference's tokens): the logits
    at every step and every cache leaf after the last."""
    cfg, jcfg, init = reference(SEAMLESS)
    enc, jenc = _encoded(3)
    params = bridge.params_from_numpy(init)
    prompt = np.random.default_rng(3).integers(0, 503, (2, 5)).astype(
        np.int32)
    jcache = jax_transformer.init_cache(jcfg, 2, 12, jnp.float32)
    cache = transformer.init_cache(cfg, 2, 12, torch.float32)
    tok = None
    for i in range(10):
        tok = prompt[:, i:i + 1] if i < 5 else tok
        jl, jcache = jitted("decode", SEAMLESS)(init, jnp.asarray(tok),
                                                jcache, jenc)
        with torch.no_grad():
            lg, cache = transformer.decode_step(
                params, cfg, torch.from_numpy(tok), cache, enc_out=enc)
        _close(f"logits at step {i}", lg.numpy(), jl)
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
        assert np.array_equal(torch.argmax(lg[:, -1:], -1).numpy(), tok)
    for key in cache:
        mine = [cache[key]] if key == "pos" else list(cache[key])
        for a, x in zip(mine, jax.tree_util.tree_leaves(jcache[key]),
                        strict=True):
            _close(f"cache {key}", a.numpy(), x)


@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_prefill_steps_match_reference(arch):
    """``make_prefill_step`` with the encoder (seamless) or the prefix
    (llava): every position's logits, and the last position's alone."""
    cfg, jcfg, init = reference(arch)
    batch = _batch(arch, 4)
    params = bridge.params_from_numpy(init)
    for last_only in (False, True):
        want = jax.jit(jax_steps.make_prefill_step(
            jcfg, last_only=last_only))(init, _jnp(batch))
        got = steps.make_prefill_step(cfg, last_only=last_only)(
            params, _torch(batch))
        assert tuple(got.shape) == want.shape
        _close(f"prefill, last_only={last_only}", got.numpy(), want)


# ------------------------------------------------------- the prefix model

def test_prefix_forward_and_text_offset_ce_match_reference():
    """llava's forward over 16 patch embeddings then 12 tokens: the logits
    at all 28 positions; the CE over the text's positions only
    (``text_offset``), and its gradient with respect to the logits."""
    cfg, _, init = reference(LLAVA)
    batch = _batch(LLAVA, 5)
    want, _ = jitted("forward", LLAVA)(
        init, batch["tokens"],
        {"prefix_embeddings": batch["frontend_embeddings"]})
    with torch.no_grad():
        got, _ = transformer.forward(
            bridge.params_from_numpy(init), cfg,
            torch.from_numpy(batch["tokens"]),
            prefix_embeddings=torch.from_numpy(batch["frontend_embeddings"]))
    assert tuple(got.shape) == (2, FRONT + 12, 503)
    _close("prefix logits", got.numpy(), want)
    assert steps.text_offset(cfg) == FRONT
    labels = batch["labels"].copy()
    labels[0, 3] = -1
    jce, jgrad = jax.jit(jax.value_and_grad(
        lambda lg: jax_steps.lm_cross_entropy(lg, labels, FRONT)))(want)
    lg = torch.from_numpy(np.array(want)).requires_grad_(True)
    ce = steps.lm_cross_entropy(lg, torch.from_numpy(labels), FRONT)
    ce.backward()
    _close("text-only CE", float(ce.detach()), float(jce))
    _close("its gradient", lg.grad.numpy(), jgrad)
    assert float(lg.grad[:, :FRONT].abs().max()) == 0.0


@pytest.mark.parametrize("k", [503, TOPK], ids=["K=V", "K=64"])
def test_kd_topk_kl_matches_reference(k):
    """The sparse KL of the teacher's renormalised top K against the
    student's full softmax, at every position, and its gradient with
    respect to the student's logits.  At K = V it is the full KL."""
    batch = _topk({"labels": np.zeros((2, 12), np.int32)}, 6, k)
    s = (np.random.default_rng(8).standard_normal((2, 12, 503)) * 3).astype(
        np.float32)
    vals, idx = batch["teacher_topk_vals"], batch["teacher_topk_idx"]
    want, jgrad = jax.jit(lambda s: (
        jax_steps.kd_topk_kl(vals, idx, s),
        jax.grad(lambda s: jnp.sum(jax_steps.kd_topk_kl(vals, idx, s)))(s)))(s)
    st = torch.from_numpy(s).requires_grad_(True)
    got = steps.kd_topk_kl(torch.from_numpy(vals), torch.from_numpy(idx), st)
    got.sum().backward()
    _close("kd_topk_kl", got.detach().numpy(), want)
    _close("its gradient", st.grad.numpy(), jgrad)
    if k == 503:
        from repro_torch.core.distillation import kl_divergence
        full = np.zeros_like(s)
        np.put_along_axis(full, idx, vals, -1)
        _close("the full KL at K = V", got.detach().numpy(), kl_divergence(
            torch.from_numpy(full), torch.from_numpy(s)).numpy())


# ------------------------------------------------------------------ steps

def _teacher(init, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.5 * rng.standard_normal(a.shape)).astype(a.dtype),
        init)


@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_fedgkd_step_matches_reference(arch):
    """One FedGKD step (a teacher that disagrees with the student, its
    encoder or prefix run too): the loss, its terms and the params
    after."""
    cfg, _, init = reference(arch)
    teacher = _teacher(init, 4)
    batch = _batch(arch, 9)
    jp, _, jm = jitted("teacher", arch)(
        init, teacher, jax_sgd(momentum=0.9).init(init), _jnp(batch))
    opt = sgd(momentum=0.9)
    params = bridge.params_from_numpy(init)
    new, _, m = steps.make_train_step(cfg, opt, kd_mode="teacher", **STEP)(
        params, bridge.params_from_numpy(teacher), opt.init(params),
        _torch(batch))
    assert sorted(m) == sorted(jm)
    for k in m:
        _close(k, float(m[k]), float(jm[k]))
    assert float(m["kd"]) > 0
    _close_trees("params after the step", new, jp)


@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_cached_topk_step_matches_reference(arch):
    """One step of the ``cached_topk`` KD mode (the teacher's top-64 logits
    at the text positions in the batch, no teacher params): the loss, its
    terms and the params after."""
    cfg, _, init = reference(arch)
    batch = _topk(_batch(arch, 10), 11)
    jp, _, jm = jitted("cached_topk", arch)(
        init, (), jax_sgd(momentum=0.9).init(init), _jnp(batch))
    opt = sgd(momentum=0.9)
    params = bridge.params_from_numpy(init)
    new, _, m = steps.make_train_step(cfg, opt, kd_mode="cached_topk",
                                      **STEP)(params, (), opt.init(params),
                                              _torch(batch))
    assert sorted(m) == sorted(jm) == ["aux", "ce", "kd", "loss"]
    for k in m:
        _close(k, float(m[k]), float(jm[k]))
    assert float(m["kd"]) > 0
    _close_trees("params after the step", new, jp)


@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_bf16_fedgkd_step_matches_reference(arch):
    """One FedGKD step of the smoke config in bf16 from a zero momentum, a
    teacher that is the mean of two inits (fp32, as the FedGKD buffer
    keeps it), its embeddings in bf16: the loss terms, the params after
    and the momentum (the gradients), dtypes leaf for leaf.  The reference
    is compiled with XLA's excess precision off, so that it rounds each
    bf16 op where its code writes it, as the port's eager ops do
    (``test_torch_bf16.py``'s ``_rounding_as_written``; the default jit
    keeps fused bf16 chains in fp32, GELU's among them).  Read once
    (seamless): the port's worst leaf, the first encoder layer norm's
    scale gradient, at 0.97 of this bar, 1.34 of the default jit's."""
    from repro.core.distillation import ensemble_average as jax_ensemble
    from repro_torch.core.distillation import ensemble_average

    _, jcfg, _ = reference(arch)
    jcfg = jcfg.replace(**BF16)
    init_fn = jax.jit(lambda k: jax_transformer.init(k, jcfg))
    init, other = (jax.tree_util.tree_map(np.asarray,
                                          init_fn(jax.random.PRNGKey(i)))
                   for i in (0, 5))
    teacher = jax.tree_util.tree_map(np.asarray, jax_ensemble([init, other]))
    batch = _batch(arch, 12)
    key = "enc_embeddings" if arch == SEAMLESS else "frontend_embeddings"
    batch[key] = np.asarray(jnp.asarray(batch[key], jnp.bfloat16))
    outs = {}
    for name, c, p, b in (("bf16", jcfg, init, batch),
                          ("fp32", jcfg.replace(**FP32), _up(init),
                           _up(batch))):
        args = (p, teacher, jax_sgd(momentum=0.9).init(p), _jnp(b))
        outs[name] = _rounding_as_written(jax_steps.make_train_step(
            c, jax_sgd(momentum=0.9), kd_mode="teacher", **STEP), *args)(
            *args)
    cfg = get_smoke_config(arch).replace(**BF16)
    teacher_port = ensemble_average([bridge.params_from_numpy(init),
                                     bridge.params_from_numpy(other)])
    opt = sgd(momentum=0.9)
    params = bridge.params_from_numpy(init)
    tb = {k: bridge.array_to_tensor(v) for k, v in batch.items()}
    new, state, m = steps.make_train_step(cfg, opt, kd_mode="teacher",
                                          **STEP)(
        params, teacher_port, opt.init(params), tb)
    (jp, jo, jm), (jp32, jo32, jm32) = outs["bf16"], outs["fp32"]
    for k in ("loss", "ce", "kd", "aux"):
        assert_bf16_parity(f"metric {k}", m[k], jm[k], jm32[k])
    assert_bf16_parity("params after the step", new, jp, jp32)
    assert_bf16_parity("momentum (the gradients)", state, jo, jo32)
