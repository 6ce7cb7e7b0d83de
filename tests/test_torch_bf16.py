"""The port's LM stack at its published dtype, bf16, against the JAX package.

On the CPU, at the reference's smoke configs (d_model 128, vocab 503; 2
layers, the hybrid 4) with bf16 parameters and activations, as every
published LM config has them: ``get_smoke_config(arch).replace(
param_dtype="bfloat16", activation_dtype="bfloat16")`` in both packages
(``reduce_for_smoke`` of the full config, the dtypes put back).  Weights
are the reference's bf16 initialisation loaded through the bridge; tokens
come from numpy seeds.

Tolerances, stated before any comparison:

* ``assert_bf16_parity``: the port rounds to bf16 at the points where the
  reference rounds, but XLA may fuse a chain of elementwise bf16 ops and
  round once where eager PyTorch rounds after each op, so the two bf16
  runs are not held to each other at a fixed bar.  Each is held to the
  reference run in fp32 from the same weights upcast (``ref32``):
  ``e_ref = max|ref_bf16 - ref32|`` and ``e_port = max|port_bf16 -
  ref32|``, per leaf, and the port must reach ``e_port <= 2 e_ref``, or
  one bf16 ulp at the leaf's magnitude (``2**-8 max|ref32|``), whichever
  is larger.  ``max|port_bf16 - ref_bf16|`` is in the assertion message.
* Every dtype equal to the reference's, leaf for leaf: parameters after a
  step, the momentum, the gradients, the caches, each layer's output, the
  logits.  This catches a missed downcast, which makes the port more
  accurate than the reference and passes the first bar.
* The plain kernel versions on bf16 inputs against ``repro.kernels.*`` in
  interpret mode at the reference's own bf16 bars (``rtol = atol``):
  KD-KL and the row logsumexp 5e-2 (``tests/test_kernels_kd_kl.py:28``),
  flash attention 2e-2 (``tests/test_kernels_flash_attention.py:45``).
  The SSD scan's casting wrapper: both packages compute the same fp32
  function of the same upcast inputs and round y once, so y is held to
  one bf16 ulp of its magnitude and the fp32 final state to 1e-5 of its.

One reference init, and one jitted forward, step or decode per
architecture and dtype, are shared across the cases.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.core.distillation import ensemble_average as jax_ensemble  # noqa: E402
from repro.kernels.flash_attention import ops as jax_flash  # noqa: E402
from repro.kernels.kd_kl import kernel as jax_kd_kernel  # noqa: E402
from repro.kernels.kd_kl import ops as jax_kd  # noqa: E402
from repro.kernels.ssd_scan import ops as jax_ssd  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.distillation import ensemble_average  # noqa: E402
from repro_torch.data.synthetic import lm_token_batches  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_gqa  # noqa: E402
from repro_torch.kernels.kd_kl.ops import kd_kl_loss, row_logsumexp  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import attention, layers, ssm, transformer  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BF16 = dict(param_dtype="bfloat16", activation_dtype="bfloat16")
FP32 = dict(param_dtype="float32", activation_dtype="float32")
ULP = 2.0 ** -8          # one bf16 ulp, relative to a magnitude
KD_TOL, FLASH_TOL, STATE_TOL = 5e-2, 2e-2, 1e-5
ARCHS = ["phi4-mini-3.8b", "mamba2-2.7b", "zamba2-1.2b"]
PORTED = ARCHS + ["minitron-4b", "granite-34b", "internlm2-20b"]
STEP = dict(gamma=0.2, lr=0.1)


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def assert_dtypes_equal(port, ref, what: str) -> None:
    """Every leaf's dtype the reference's, in the same order."""
    got = [_dtype(x) for x in _leaves(port)]
    want = [_dtype(x) for x in jax.tree_util.tree_leaves(ref)]
    assert got == want, f"{what}: dtypes {got} != reference {want}"


def assert_bf16_parity(what: str, port, ref_bf16, ref32) -> None:
    """The module's bar, leaf for leaf, and the dtypes."""
    assert_dtypes_equal(port, ref_bf16, what)
    rows = []
    for i, (p, r, f) in enumerate(zip(
            _leaves(port), jax.tree_util.tree_leaves(ref_bf16),
            jax.tree_util.tree_leaves(ref32), strict=True)):
        p, r, f = _np32(p), _np32(r), _np32(f)
        assert p.shape == r.shape == f.shape, (what, i, p.shape, r.shape)
        e_ref = float(np.max(np.abs(r - f), initial=0.0))
        e_port = float(np.max(np.abs(p - f), initial=0.0))
        bar = max(2.0 * e_ref, ULP * float(np.max(np.abs(f), initial=0.0)))
        rows.append((i, e_port, e_ref, bar,
                     float(np.max(np.abs(p - r), initial=0.0))))
    bad = [r for r in rows if not r[1] <= r[3]]
    assert not bad, (f"{what}: (leaf, e_port, e_ref, bar, |port - ref_bf16|) "
                     f"over the bar: {bad}")


def _tokens(seed, batch=2, seq=17):
    return lm_token_batches(np.random.default_rng(seed), batch, seq, 503)


def _up(tree):
    """A numpy tree with every bf16 leaf cast up to fp32 (exact)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype.name == "bfloat16"
        else a, tree)


_REF: dict = {}


def reference(arch):
    """(port cfg, reference bf16 cfg, reference fp32 cfg, the reference's
    bf16 init as numpy), once per architecture."""
    if arch not in _REF:
        jcfg = jax_get_smoke(arch).replace(**BF16)
        init = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jax_transformer.init(k, jcfg))(jax.random.PRNGKey(0)))
        _REF[arch] = (get_smoke_config(arch).replace(**BF16), jcfg,
                      jcfg.replace(**FP32), init)
    return _REF[arch]


# ------------------------------------------------------------------ bridge

def test_bridge_carries_bf16_both_ways():
    """A JAX bf16 array through ``np.asarray`` into a bf16 tensor with the
    same bits, and back into numpy's bf16 type, which JAX reads."""
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (3, 5)) * 100,
                   ).astype(jnp.bfloat16)
    tree = {"w": a, "n": {"s": np.arange(4, dtype=np.float32)}}
    t = bridge.params_from_numpy(tree)
    assert t["w"].dtype == torch.bfloat16 and t["n"]["s"].dtype == torch.float32
    assert np.array_equal(t["w"].view(torch.int16).numpy(), a.view(np.int16))
    back = bridge.params_to_numpy(t)
    assert back["w"].dtype.name == "bfloat16"
    assert back["w"].tobytes() == a.tobytes()
    assert np.array_equal(np.asarray(jnp.asarray(back["w"]) * 1), a)
    _, _, _, init = reference("mamba2-2.7b")
    params = bridge.params_from_numpy(init)
    assert_dtypes_equal(params, init, "mamba2 init through the bridge")
    assert all(x.tobytes() == y.tobytes() for x, y in zip(
        jax.tree_util.tree_leaves(bridge.params_to_numpy(params)),
        jax.tree_util.tree_leaves(init)))


# ------------------------------------------------------------------ layers

def _layer_cases():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 6, 32)) * 3).astype(jnp.bfloat16)
    key = jax.random.PRNGKey(1)
    bf = jnp.bfloat16
    mk = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    pos = np.broadcast_to(np.arange(6), (2, 6)).copy()
    norm = {"scale": np.asarray(1 + rng.standard_normal(32) / 4).astype(bf),
            "bias": np.asarray(rng.standard_normal(32) / 4).astype(bf)}
    return x, [
        ("dense", mk(jax_layers.dense_bias_init(key, 32, 48, bf)),
         jax_layers.dense, layers.dense),
        # an fp32 weight under bf16 activations: the FedGKD teacher's case
        ("dense, fp32 weight", mk(jax_layers.dense_init(key, 32, 48)),
         jax_layers.dense, layers.dense),
        ("rmsnorm", {"scale": norm["scale"]}, jax_layers.rmsnorm,
         layers.rmsnorm),
        ("layernorm", norm, jax_layers.layernorm, layers.layernorm),
        ("swiglu", mk(jax_layers.swiglu_init(key, 32, 64, bf)),
         jax_layers.swiglu, layers.swiglu),
        ("gelu_mlp", mk(jax_layers.gelu_mlp_init(key, 32, 64, bf)),
         jax_layers.gelu_mlp, layers.gelu_mlp),
        ("unembed", mk(jax_layers.embedding_init(key, 50, 32, bf)),
         jax_layers.unembed, layers.unembed),
        ("apply_rope", pos, lambda p, x: jax_layers.apply_rope(
            x.reshape(2, 6, 4, 8), p), lambda p, x: layers.apply_rope(
            x.reshape(2, 6, 4, 8), p)),
    ]


def _reference_outputs(cases, x):
    """Every case's reference output in bf16 and in fp32 (params and x cast
    up), each dtype's cases in one jitted call."""
    ps = [p for _, p, _, _ in cases]
    run = jax.jit(lambda ps, x: [jfn(p, x) for (_, _, jfn, _), p
                                 in zip(cases, ps)])
    return (run(ps, jnp.asarray(x)),
            run([_up(p) for p in ps], jnp.asarray(x, jnp.float32)))


def test_layers_match_reference_in_bf16():
    x, cases = _layer_cases()
    xt = bridge.params_from_numpy({"x": x})["x"]
    for (name, p, _, fn), want, want32 in zip(
            cases, *_reference_outputs(cases, x)):
        tp = (torch.from_numpy(np.asarray(p)) if isinstance(p, np.ndarray)
              else bridge.params_from_numpy(p))
        assert_bf16_parity(name, fn(tp, xt), want, want32)


def test_embed_and_the_model_cast_to_the_activation_dtype():
    cfg, jcfg, _, init = reference("phi4-mini-3.8b")
    toks = _tokens(1)
    params = bridge.params_from_numpy(init)
    h = layers.embed(params["embed"], torch.from_numpy(toks))
    jh = jax_layers.embed(init["embed"], jnp.asarray(toks))
    assert _dtype(h) == _dtype(jh) == "bfloat16"
    assert np.array_equal(_np32(h), _np32(jh))


def _attn_kw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta)


def test_attention_ssm_and_hybrid_layers_match_reference():
    """One GQA attention, one Mamba-2 block and the hybrid's shared block,
    each from the smoke model's own bf16 weights."""
    x = (np.random.default_rng(2).standard_normal((2, 17, 128))
         ).astype(jnp.bfloat16)
    xt = bridge.params_from_numpy({"x": x})["x"]
    pos = np.broadcast_to(np.arange(17), (2, 17)).copy()
    cfg, jcfg, jcfg32, init = reference("zamba2-1.2b")
    seg = jax.tree_util.tree_map(lambda a: a[0], init["seg0"])
    sb = init["shared_block"]
    kw = _attn_kw(cfg)
    cases = [
        ("gqa_attention", sb["attn"],
         lambda p, x: jax_attention.gqa_attention(p, x, positions=pos, **kw),
         lambda p, x: attention.gqa_attention(p, x, positions=torch.from_numpy(
             pos), **kw)),
        ("mamba2_forward", seg["mixer"],
         lambda p, x: jax_ssm.mamba2_forward(p, x, jcfg.ssm),
         lambda p, x: ssm.mamba2_forward(p, x, cfg.ssm)),
        ("shared block", sb,
         lambda p, x: jax_transformer._shared_block(
             jcfg, p, x, x * 0.5, jnp.asarray(pos)),
         lambda p, x: transformer._shared_block(
             cfg, p, x, x * 0.5, torch.from_numpy(pos))),
    ]
    for (name, p, _, fn), want, want32 in zip(
            cases, *_reference_outputs(cases, x)):
        assert_bf16_parity(name, fn(bridge.params_from_numpy(p), xt), want,
                           want32)


# ------------------------------------------------------------------ models

_FWD: dict = {}


def _jit_forward(jcfg):
    if jcfg not in _FWD:
        _FWD[jcfg] = jax.jit(lambda p, t: jax_transformer.forward(p, jcfg, t))
    return _FWD[jcfg]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """The logits (fp32 in both) and the final hidden states (bf16)."""
    cfg, jcfg, jcfg32, init = reference(arch)
    toks = _tokens(3, seq=24)
    want, _ = _jit_forward(jcfg)(init, toks)
    want32, _ = _jit_forward(jcfg32)(_up(init), toks)
    with torch.no_grad():
        got, aux = transformer.forward(bridge.params_from_numpy(init), cfg,
                                       torch.from_numpy(toks))
        h, _ = transformer.hidden_states(bridge.params_from_numpy(init), cfg,
                                         torch.from_numpy(toks))
    jh, _ = jax.eval_shape(lambda p, t: jax_transformer.hidden_states(
        p, jcfg, t), init, toks)
    assert _dtype(h) == _dtype(jh) == "bfloat16"
    assert _dtype(aux) == "float32"
    assert_bf16_parity(f"{arch} logits", got, want, want32)


_STEPS: dict = {}


def reference_step(jcfg):
    """The reference's jitted FedGKD step for ``jcfg``: ``make_train_step``
    with ``run_serial``'s optimizer (SGD, momentum 0.9), kd mode, gamma and
    lr, compiled once and shared by the step and the round tests."""
    if jcfg not in _STEPS:
        _STEPS[jcfg] = jax.jit(jax_steps.make_train_step(
            jcfg, jax_sgd(momentum=0.9), kd_mode="teacher", **STEP))
    return _STEPS[jcfg]


class _SharedStepJax:
    """``jax`` as ``repro.launch.train`` sees it, but for ``jit``, which
    hands back ``reference_step`` (the same function of the same
    arguments, already compiled), so the round test compiles no step of
    its own; ``run_serial`` itself runs as it is."""

    def __init__(self, step):
        self._step = step

    def jit(self, fn):
        return self._step

    def __getattr__(self, name):
        return getattr(jax, name)


def test_sgd_momentum_takes_the_params_dtype():
    """SGD's momentum state in each parameter's dtype (bf16 beside an fp32
    leaf, as a Mamba-2 layer's ``A_log``), as the reference's
    ``state_dtype or p.dtype``; three eager steps with momentum and weight
    decay round at the same points in both packages, so the params and
    the state come out equal."""
    rng = np.random.default_rng(11)
    tree = lambda: {"w": rng.standard_normal((4, 3)).astype(jnp.bfloat16),
                    "A_log": rng.standard_normal(3).astype(np.float32)}
    init, grads = tree(), [tree() for _ in range(3)]
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    jopt, opt = jax_sgd(momentum=0.9, weight_decay=1e-2), \
        sgd(momentum=0.9, weight_decay=1e-2)
    jp, p = to_jax(init), bridge.params_from_numpy(init)
    js, st = jopt.init(jp), opt.init(p)
    assert_dtypes_equal(st, js, "momentum at init")
    for g in grads:
        ju, js = jopt.update(to_jax(g), js, jp, 0.1)
        jp = jax.tree_util.tree_map(lambda a, u: a + u.astype(a.dtype), jp, ju)
        with torch.no_grad():
            u, st = opt.update(bridge.params_from_numpy(g), st, p, 0.1)
            p = {k: p[k] + u[k].to(p[k].dtype) for k in p}
    for what, mine, ref in (("params", p, jp), ("momentum", st, js)):
        assert_dtypes_equal(mine, ref, what)
        for a, b in zip(_leaves(mine), jax.tree_util.tree_leaves(ref)):
            assert np.array_equal(_np32(a), _np32(b)), what


def _fedgkd_inputs(arch):
    """(batch, teacher): the teacher the fp32 mean of the bf16 init and a
    second bf16 init, as ``ensemble_average`` makes it."""
    _, jcfg, _, init = reference(arch)
    other = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jax_transformer.init(k, jcfg))(jax.random.PRNGKey(5)))
    teacher = jax.tree_util.tree_map(np.asarray, jax_ensemble([init, other]))
    toks = _tokens(4)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, teacher, other


def test_fedgkd_step_matches_reference():
    """One FedGKD step of phi4-mini from a zero momentum: the loss and its
    terms, the params after, the momentum (0.9·0 + g: the gradients
    themselves) against the reference's, and the fp32 teacher's forward
    under bf16 activations."""
    arch = "phi4-mini-3.8b"
    cfg, jcfg, jcfg32, init = reference(arch)
    batch, teacher_np, other = _fedgkd_inputs(arch)
    teacher_port = ensemble_average([bridge.params_from_numpy(init),
                                     bridge.params_from_numpy(other)])
    assert_dtypes_equal(teacher_port, teacher_np, "the teacher")
    outs = {}
    for name, c, p in (("bf16", jcfg, init), ("fp32", jcfg32, _up(init))):
        outs[name] = reference_step(c)(
            p, teacher_np, jax_sgd(momentum=0.9).init(p),
            jax.tree_util.tree_map(jnp.asarray, batch))
    opt = sgd(momentum=0.9)
    step = steps.make_train_step(cfg, opt, kd_mode="teacher", **STEP)
    params = bridge.params_from_numpy(init)
    state = opt.init(params)
    assert_dtypes_equal(state, jax_sgd(momentum=0.9).init(init),
                        "momentum at init")
    new, new_state, m = step(params, bridge.params_from_numpy(teacher_np),
                             state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    (jp, jo, jm), (jp32, jo32, jm32) = outs["bf16"], outs["fp32"]
    assert float(jm["kd"]) > 0 and float(m["kd"]) > 0
    for k in ("loss", "ce", "kd", "aux"):
        assert_bf16_parity(f"metric {k}", m[k], jm[k], jm32[k])
    assert_bf16_parity("params after the step", new, jp, jp32)
    assert_bf16_parity("momentum (the gradients)", new_state, jo, jo32)


def _rounding_as_written(fn, *args):
    """``fn`` compiled for ``args`` with XLA's excess precision off: each
    bf16 op is rounded where the code writes it, as in the reference run
    op by op under ``jax.disable_jit()`` (the default jit may keep a fused
    chain of bf16 ops in fp32 and round once at its end, which eager
    PyTorch does not do).  Compiling takes seconds where the op-by-op run
    takes ~25 s here."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})


def test_mamba2_local_steps_match_reference():
    """A FedGKD client's two local steps on mamba2 in bf16: ``run_serial``'s
    client 0 of round 1 (its two batches, the round's teacher, the fp32
    mean of the init, SGD with momentum 0.9), against the reference's step
    compiled by ``_rounding_as_written`` and, for the fp32 side of the
    bar, its jitted fp32 step from the same state upcast.

    * step 1 from the init, and step 2 from the reference's state after
      step 1 (params and momentum): the params, the momentum and the loss
      under the module's bar;
    * step 2 from the port's own state after step 1: the port's params and
      momentum no further from the fp32 trajectory than twice the
      reference's step from that same state.  Step 2 amplifies the
      one-ulp differences of step 1's state several times over, the same
      in both packages (ROADMAP C), so the two trajectories are each held
      against the reference's step from their own state.

    The KD term is held through the loss it enters: at step 2 it is the KL
    between two forwards one step apart (0 at step 1), so most of its
    value is their bf16 rounding, and its own 2x bar is a coin toss."""
    arch = "mamba2-2.7b"
    cfg, jcfg, jcfg32, init = reference(arch)
    data = train.client_batches(cfg, 1, 2, 2, 17, seed=0)[0]
    batches = [{"tokens": b[:, :-1], "labels": b[:, 1:]} for b in data]
    teacher = jax.tree_util.tree_map(np.asarray, jax_ensemble([init]))
    zero = jax_sgd(momentum=0.9).init(init)
    ref = _rounding_as_written(jax_steps.make_train_step(
        jcfg, jax_sgd(momentum=0.9), kd_mode="teacher", **STEP),
        init, teacher, zero, batches[0])
    ref32 = reference_step(jcfg32)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    opt = sgd(momentum=0.9)
    step = steps.make_train_step(cfg, opt, kd_mode="teacher", **STEP)
    teacher_t = bridge.params_from_numpy(teacher)

    def port(p, m, b):
        p, m, metrics = step(bridge.params_from_numpy(p), teacher_t,
                             bridge.params_from_numpy(m),
                             {k: torch.from_numpy(v) for k, v in b.items()})
        return p, m, metrics

    def held(what, got, want, want32):
        assert_bf16_parity(f"{what} params", got[0], want[0], want32[0])
        assert_bf16_parity(f"{what} momentum", got[1], want[1], want32[1])
        if len(got) > 2:
            assert_bf16_parity(f"{what} loss", got[2]["loss"],
                               want[2]["loss"], want32[2]["loss"])

    r1 = as_np(ref(init, teacher, zero, batches[0]))
    f1 = ref32(_up(init), teacher, _up(zero), batches[0])
    p1 = port(init, zero, batches[0])
    held("step 1", p1, r1, f1)
    f2 = ref32(f1[0], teacher, f1[1], batches[1])
    held("step 2 from the reference's state",
         port(r1[0], r1[1], batches[1]),
         ref(r1[0], teacher, r1[1], batches[1]),
         ref32(_up(r1[0]), teacher, _up(r1[1]), batches[1]))
    own = [as_np(bridge.params_to_numpy(t)) for t in p1[:2]]
    p2 = port(own[0], own[1], batches[1])
    held("step 2 of the port's trajectory", p2[:2],
         ref(own[0], teacher, own[1], batches[1])[:2], f2[:2])


def test_run_serial_round_matches_reference(monkeypatch):
    """One FedGKD round of phi4-mini in bf16, 2 clients x 2 batches: the
    global params, the round's loss and its eval CE, from the reference's
    bf16 init (the fp32 reference from it upcast); the reference's
    ``run_serial`` steps with ``reference_step``, whose batches have this
    round's shapes."""
    arch = "phi4-mini-3.8b"
    cfg, jcfg, jcfg32, init = reference(arch)
    run = dict(rounds=1, n_clients=2, batches_per_round=2, batch=2, seq=17,
               lr=STEP["lr"], gamma=STEP["gamma"], seed=0)
    want = {}
    for name, c, p in (("bf16", jcfg, init), ("fp32", jcfg32, _up(init))):
        monkeypatch.setattr(jax_transformer, "init", lambda key, c, p=p: p)
        monkeypatch.setattr(jax_train, "jax", _SharedStepJax(
            reference_step(c)))
        want[name] = jax_train.run_serial(c, algo="fedgkd", verbose=False,
                                          **run)
    monkeypatch.setattr(transformer, "init",
                        lambda gen, c: bridge.params_from_numpy(init))
    got = train.run_serial(cfg, algo="fedgkd", verbose=False, device="cpu",
                           **run)
    assert_bf16_parity("round 1 params", got["params"],
                       want["bf16"]["params"], want["fp32"]["params"])
    ce = lambda out: np.log(np.float32(out["history"][0]["ppl"]))
    loss = lambda out: np.float32(out["history"][0]["loss"])
    for what, f in (("eval CE", ce), ("loss", loss)):
        assert_bf16_parity(what, torch.tensor(f(got)), f(want["bf16"]),
                           f(want["fp32"]))


def test_greedy_decode_with_bf16_caches_matches_reference():
    """4 greedy steps of the hybrid (a 2-token prompt, then the reference's
    argmax fed to both) over ``init_cache``'s default caches, bf16 as the
    reference's: the logits, and every cache leaf after the last step (the
    shared block's KV caches and the conv states bf16, the SSM states
    fp32), dtypes and values."""
    arch = "zamba2-1.2b"
    cfg, jcfg, jcfg32, init = reference(arch)
    prompt = _tokens(5, seq=2)
    params = bridge.params_from_numpy(init)
    runs = {name: [jax.jit(lambda p, t, c, jc=jc: jax_transformer.decode_step(
        p, jc, t, c)), p, jax_transformer.init_cache(jc, 2, 8, dt)]
        for name, jc, p, dt in (("bf16", jcfg, init, jnp.bfloat16),
                                ("fp32", jcfg32, _up(init), jnp.float32))}
    cache = transformer.init_cache(cfg, 2, 8)
    assert_dtypes_equal(cache, runs["bf16"][2], "the empty caches")
    got, want = [], {"bf16": [], "fp32": []}
    tok = prompt[:, :1]
    for i in range(4):
        tok = prompt[:, i:i + 1] if i < prompt.shape[1] else tok
        for name, run in runs.items():
            lg, run[2] = run[0](run[1], jnp.asarray(tok), run[2])
            want[name].append(np.asarray(lg)[:, 0])
        with torch.no_grad():
            lg, cache = transformer.decode_step(params, cfg,
                                                torch.from_numpy(tok), cache)
        got.append(lg[:, 0])
        tok = np.argmax(want["bf16"][-1], axis=-1)[:, None].astype(np.int32)
    assert_bf16_parity(f"{arch} decode logits", torch.stack(got, 1),
                       np.stack(want["bf16"], 1), np.stack(want["fp32"], 1))
    jcache = dict(runs["bf16"][2])
    for key in sorted(jcache):
        mine = [cache[key]] if key == "pos" else list(cache[key])
        ref32 = runs["fp32"][2][key]
        assert_bf16_parity(f"{arch} cache {key}", mine, jcache[key], ref32)


@pytest.mark.parametrize("arch", PORTED)
def test_every_registered_config_runs_in_bf16(arch, monkeypatch):
    """``transformer.init``, ``forward``, ``init_cache``, ``decode_step``,
    ``run_serial`` and ``ServeLoop`` on each registered LM config, reduced,
    at its published bf16 dtypes: finite, with the reference's dtypes
    (its init and its caches, leaf for leaf, from ``jax.eval_shape``), and
    ``ServeLoop``'s caches fp32, as the reference's ServeLoop asks for."""
    from repro_torch.launch import serve

    jcfg = jax_get_smoke(arch).replace(**BF16)
    cfg = get_smoke_config(arch).replace(**BF16)
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    assert_dtypes_equal(params, jax.eval_shape(
        lambda: jax_transformer.init(jax.random.PRNGKey(0), jcfg)), "init")
    toks = torch.from_numpy(_tokens(10, seq=9))
    with torch.no_grad():
        logits, _ = transformer.forward(params, cfg, toks)
    assert _dtype(logits) == "float32" and bool(logits.isfinite().all())
    cache = transformer.init_cache(cfg, 2, 4)
    assert_dtypes_equal(cache, jax.eval_shape(
        lambda: jax_transformer.init_cache(jcfg, 2, 4)), "init_cache")
    for i in range(2):
        with torch.no_grad():
            lg, cache = transformer.decode_step(params, cfg, toks[:, i:i + 1],
                                                cache)
    assert bool(lg.isfinite().all())
    assert_dtypes_equal(cache, jax.eval_shape(
        lambda: jax_transformer.init_cache(jcfg, 2, 4)), "decoded caches")
    monkeypatch.setattr(transformer, "init", lambda gen, c: params)
    out = train.run_serial(cfg, rounds=1, n_clients=2, batches_per_round=1,
                           batch=2, seq=9, device="cpu", verbose=False)
    assert_dtypes_equal(out["params"], jax.eval_shape(
        lambda: jax_transformer.init(jax.random.PRNGKey(0), jcfg)),
        "run_serial's params")
    assert np.isfinite(out["history"][0]["loss"])
    asked = []
    real = transformer.init_cache
    monkeypatch.setattr(transformer, "init_cache", lambda *a, **k: (
        asked.append(a[3] if len(a) > 3 else k.get("dtype")), real(*a, **k))[1])
    stats = serve.ServeLoop(cfg, params, 2, 8).run(
        serve.make_prompts(3, cfg.vocab_size, 5), 2)
    assert len(stats["outputs"]) == 3 and asked == [torch.float32] * 2


# ----------------------------------------------------------------- kernels

def test_kd_kl_plain_version_matches_reference_kernel_in_bf16():
    """KL and its student gradient on bf16 logits (the gradient in bf16, as
    the reference's wrapper returns it), the reference's Pallas kernel in
    interpret mode, at its 5e-2."""
    rng = np.random.default_rng(6)
    lt, ls = ((rng.standard_normal((64, 256)) * 3).astype(jnp.bfloat16)
              for _ in range(2))
    jf = lambda s: jnp.sum(jax_kd.kd_kl_loss(jnp.asarray(lt), s,
                                             block_rows=32, block_vocab=128))
    want, jg = jax_kd.kd_kl_loss(jnp.asarray(lt), jnp.asarray(ls),
                                 block_rows=32, block_vocab=128), \
        jax.grad(jf)(jnp.asarray(ls))
    t = bridge.params_from_numpy({"t": lt, "s": ls})
    s = t["s"].requires_grad_(True)
    got = kd_kl_loss(t["t"], s)
    got.sum().backward()
    assert _dtype(got) == _dtype(want) == "float32"
    assert _dtype(s.grad) == _dtype(jg) == "bfloat16"
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=KD_TOL,
                               atol=KD_TOL)
    np.testing.assert_allclose(_np32(s.grad), _np32(jg), rtol=KD_TOL,
                               atol=KD_TOL)


def test_row_logsumexp_plain_version_matches_reference_kernel_in_bf16():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((64, 256)) * 3).astype(jnp.bfloat16)
    want = jax_kd_kernel.row_logsumexp(jnp.asarray(x), block_rows=32,
                                       block_vocab=128, interpret=True)
    got = row_logsumexp(bridge.params_from_numpy({"x": x})["x"])
    assert _dtype(got) == _dtype(want) == "float32"
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=KD_TOL,
                               atol=KD_TOL)


@pytest.mark.parametrize("window", [None, 16])
def test_flash_plain_version_matches_reference_kernel_in_bf16(window):
    """The reference's bf16 case (1, 64, 4/2, 64) and a window: the plain
    version rounds P to bf16 before P·V, the kernel keeps it fp32; both
    inside the reference's 2e-2."""
    ks = jax.random.split(jax.random.PRNGKey(8), 3)
    q, k, v = (jax.random.normal(kk, shape).astype(jnp.bfloat16)
               for kk, shape in zip(ks, [(1, 64, 4, 64), (1, 64, 2, 64),
                                         (1, 64, 2, 64)]))
    want = jax_flash.flash_attention_gqa(q, k, v, window=window, block_q=32,
                                         block_kv=32, interpret=True)
    t = bridge.params_from_numpy({"q": np.asarray(q), "k": np.asarray(k),
                                  "v": np.asarray(v)})
    got = flash_attention_gqa(t["q"], t["k"], t["v"], window=window)
    assert _dtype(got) == _dtype(want) == "bfloat16"
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=FLASH_TOL,
                               atol=FLASH_TOL)


def test_ssd_scan_casting_wrapper_matches_reference_in_bf16():
    """B5's wrapper on bf16 x, B, C (dt and A fp32): y in bf16, the final
    state fp32, as the reference's wrapper returns them."""
    rng = np.random.default_rng(9)
    b, l, h, p, g, n, chunk = 2, 40, 4, 16, 1, 16, 16
    x = rng.standard_normal((b, l, h, p)).astype(jnp.bfloat16)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) - 2)).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(jnp.bfloat16)
    C = rng.standard_normal((b, l, g, n)).astype(jnp.bfloat16)
    wy, ws = jax_ssd.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                              chunk=chunk, interpret=True)
    t = bridge.params_from_numpy(dict(x=x, dt=dt, A=A, B=B, C=C))
    y, s = ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk=chunk)
    assert (_dtype(y), _dtype(s)) == (_dtype(wy), _dtype(ws)) == (
        "bfloat16", "float32")
    wy = _np32(wy)
    assert np.max(np.abs(_np32(y) - wy)) <= ULP * np.max(np.abs(wy))
    assert np.max(np.abs(_np32(s) - _np32(ws))) <= STATE_TOL * np.max(
        np.abs(_np32(ws)))
