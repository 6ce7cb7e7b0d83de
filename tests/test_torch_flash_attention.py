"""The port's flash-attention op against the JAX package's, on the CPU.

Forward: ``repro_torch.kernels.flash_attention.ops.flash_attention_gqa``
(on CPU tensors, its plain version) against
``repro.kernels.flash_attention.ops.flash_attention_gqa`` run as the
reference's own tests run it, the Pallas kernel in interpret mode with
32-row blocks.  Backward: the op's hand-written backward (the one the card
runs too) against ``jax.grad`` of the reference's ``attention_ref``, for
q, k and v.  Inputs are standard normal, made by numpy from a seed.
Tolerance: 1e-5 absolute on outputs and gradients of magnitude ~1-10
(fp32; online softmax against a one-pass softmax, different summation
orders).
"""
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention import ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
BLOCK = 32

# (B, S, Hq, Hkv, D, causal, window)
CASES = {
    "causal_s32": (2, 32, 4, 2, 32, True, None),
    "causal_s64": (2, 64, 4, 2, 32, True, None),
    "causal_s100": (2, 100, 4, 2, 32, True, None),
    "gqa_4_4": (1, 64, 4, 4, 32, True, None),
    "gqa_8_2": (1, 64, 8, 2, 32, True, None),
    "gqa_8_1": (1, 64, 8, 1, 32, True, None),
    "window16": (1, 128, 4, 2, 32, True, 16),
    "window32": (1, 128, 4, 2, 32, True, 32),
    "d32": (1, 64, 2, 2, 32, True, None),
    "d64": (1, 64, 2, 2, 64, True, None),
    "d128": (1, 64, 2, 2, 128, True, None),
    "noncausal_aligned": (1, 64, 4, 4, 32, False, None),
}
GRAD_CASES = ["causal_s100", "gqa_8_2", "window16", "d128",
              "noncausal_aligned"]


def _inputs(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_reference_kernel(name):
    b, s, hq, hkv, d, causal, window = CASES[name]
    q, k, v = _inputs(b, s, hq, hkv, d, seed=len(name))
    want = jax.jit(functools.partial(
        jax_ops.flash_attention_gqa, causal=causal, window=window,
        block_q=BLOCK, block_kv=BLOCK, interpret=True))(q, k, v)
    got = ops.flash_attention_gqa(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window)
    assert got.shape == (b, s, hq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradients_match_reference(name):
    b, s, hq, hkv, d, causal, window = CASES[name]
    q, k, v = _inputs(b, s, hq, hkv, d, seed=100 + len(name))
    g = np.random.default_rng(7).standard_normal((b, s, hq, d)).astype(
        np.float32)

    def f(q, k, v):
        return jnp.sum(jax_ref.attention_ref(q, k, v, causal=causal,
                                             window=window) * g)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops.flash_attention_gqa(tq, tk, tv, causal=causal, window=window)
    (out * torch.from_numpy(g)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)


def test_plain_version_is_the_reference_attention():
    """``ref.attention_ref`` (the CPU path and the card's yardstick) is
    the reference's plain attention, mask value and GQA grouping included,
    on a ragged non-causal shape that the reference's kernel sends to it."""
    q, k, v = _inputs(2, 37, 6, 3, 16, seed=5)
    want = jax.jit(functools.partial(jax_ref.attention_ref,
                                     causal=False))(q, k, v)
    got = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 8, 6, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention_gqa(q, torch.zeros(1, 8, 4, 16),
                                torch.zeros(1, 8, 4, 16))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_gqa(q, torch.zeros(1, 8, 3, 16),
                                torch.zeros(1, 8, 3, 16), window=0)


# (B, S, Hq, D): the text path's local step, evaluation batch and a teacher
# chunk, one token, a ragged S = 100, and head dims up to the kernel's 128
@pytest.mark.parametrize("b,s,hq,d", [(64, 64, 4, 32), (256, 64, 4, 32),
                                      (405, 64, 4, 32), (64, 1, 4, 32),
                                      (8, 100, 4, 128), (3, 128, 8, 64),
                                      (2, 37, 6, 7), (1, 300, 2, 96)])
def test_launch_plan_covers_rows_within_shared_memory(b, s, hq, d):
    """A block per (batch * query head, 64 query rows) of 4 warps; the q
    tile and two stages of k and v tiles, head_dim padded to a multiple
    of 32 and rows to +4 floats, fit a block's 227 KB."""
    (gx, gy), threads, smem = ops.launch_plan(b, s, hq, d)
    assert gx == b * hq and threads == 128
    assert (gy - 1) * ops.BLOCK_Q < s <= gy * ops.BLOCK_Q
    dp = -(-d // 32) * 32
    assert smem == 4 * (ops.BLOCK_Q + 4 * ops.BLOCK_KV) * (dp + 4)
    assert smem <= ops.MAX_SMEM == 227 * 1024


# the shapes above, phi4-mini's FedGKD step (2, 1,024, 24, 128) and
# evaluation, and zamba2's shared block at its prefill (4, 1,024, 32, 64)
@pytest.mark.parametrize("b,s,hq,d", [(64, 64, 4, 32), (256, 64, 4, 32),
                                      (405, 64, 4, 32), (64, 1, 4, 32),
                                      (8, 100, 4, 128), (3, 128, 8, 64),
                                      (2, 37, 6, 7), (1, 300, 2, 96),
                                      (2, 1024, 24, 128), (8, 1024, 24, 128),
                                      (4, 1024, 32, 64)])
def test_bf16_launch_plan_covers_rows_within_shared_memory(b, s, hq, d):
    """The bf16 form's plan: a block per (batch * query head, 64 query
    rows a warpgroup) of a copying warp and two warpgroups, three at
    head_dim <= 64; the q tile and three stages of k and v tiles in bf16 at
    head_dim 64 or 128 (one or two 64-column atoms of 128-byte rows) and
    1,024 bytes of alignment fit a block's 227 KB."""
    (gx, gy), threads, smem = ops.launch_plan(b, s, hq, d, torch.bfloat16)
    atoms = 1 if d <= 64 else 2
    consumers = 3 if d <= 64 else 2
    rows = 64 * consumers
    assert gx == b * hq and threads == 128 * consumers + 32
    assert (gy - 1) * rows < s <= gy * rows
    assert smem == 1024 + (rows + 3 * 2 * 64) * 128 * atoms
    assert smem <= ops.MAX_SMEM
    assert ops.launch_plan(b, s, hq, d) != ((gx, gy), threads, smem)
