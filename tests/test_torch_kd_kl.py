"""The port's fused KD-KL loss against the reference's Pallas kernel.

On the CPU the port's wrappers take their plain versions; the reference runs
its Pallas kernel in interpret mode, as its own tests do.  Forward value
and student gradient agree within 1e-5 absolute (fp32, the reference's
bar) on unit-scale logits, where the loss is O(1) and fp32 resolves that
bar; the teacher gets no gradient.  The CUDA kernels are held
against these plain versions on the card by ``test_torch_gpu.py``.

The CUDA forward's own arithmetic cannot run here, so a numpy float32
mirror of it (``mirror_kd_kl_fwd``: the threads' strided 16-byte parts
with a scalar head peeled to the first aligned address and a scalar tail,
the vector-max-then-rescale update with one exponential an element, the
lane and warp merge tree with its empty parts; and the first form's
warp-per-row update) is held against the reference's Pallas kernel in
interpret mode at the same 1e-5.
"""
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.kd_kl import ops as jax_ops  # noqa: E402
from repro_torch.kernels.kd_kl import ops, ref  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

CASES = [(7, 10), (64, 100), (33, 200)]
TEMPS = [1.0, 2.0]
TOL = 1e-5


def _logits(t, v, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, v)).astype(np.float32),
            rng.standard_normal((t, v)).astype(np.float32),
            rng.standard_normal(t).astype(np.float32))


@pytest.mark.parametrize("temp", TEMPS)
@pytest.mark.parametrize("t,v", CASES)
def test_kd_kl_matches_reference_kernel(t, v, temp):
    lt, ls, g = _logits(t, v, seed=t * 1000 + v)

    def jax_obj(ls_):
        kl = jax_ops.kd_kl_loss(jnp.asarray(lt), ls_, temperature=temp,
                                block_rows=16, block_vocab=128,
                                use_pallas=True, interpret=True)
        return jnp.sum(kl * g), kl

    (_, jkl), jgrad = jax.value_and_grad(jax_obj, has_aux=True)(jnp.asarray(ls))

    tlt = torch.from_numpy(lt).requires_grad_(True)
    tls = torch.from_numpy(ls).requires_grad_(True)
    kl = ops.kd_kl_loss(tlt, tls, temperature=temp)
    (kl * torch.from_numpy(g)).sum().backward()

    np.testing.assert_allclose(kl.detach().numpy(), np.asarray(jkl),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tls.grad.numpy(), np.asarray(jgrad),
                               rtol=0, atol=TOL)
    assert tlt.grad is None or not bool(tlt.grad.any())


def test_kd_kl_keeps_leading_dims():
    lt, ls, _ = _logits(12, 10, seed=5)
    out = ops.kd_kl_loss(torch.from_numpy(lt).reshape(3, 4, 10),
                         torch.from_numpy(ls).reshape(3, 4, 10))
    assert out.shape == (3, 4)



# ------------------------------------------- a mirror of csrc/kd_kl.cu B1

_F = np.float32
_NEG_INIT = _F(-1e30)
_LOG2E = _F(1.4426950408889634)
# (threads, elements a 16-byte load, the update): the block form of 512
# threads on fp32 (4) and bf16 (8) widths, and the first form's warp
MIRROR_FORMS = [(512, 4, "block"), (512, 8, "block"), (32, 1, "warp")]


def _fma(a, b, c):
    """fp32 fma: the product of two fp32 values is exact in fp64."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(_F)


def _merge(a, b):
    """``merge()`` of kd_kl.cu on arrays of parts: (mt, st, acc, ms, ss)."""
    mt = np.maximum(a[0], b[0])
    ca, cb = np.exp(a[0] - mt), np.exp(b[0] - mt)
    ms = np.maximum(a[3], b[3])
    return (mt, a[1] * ca + b[1] * cb, a[2] * ca + b[2] * cb, ms,
            a[4] * np.exp(a[3] - ms) + b[4] * np.exp(b[3] - ms))


def _warp_merge(parts):
    """The shuffle tree (xor 16, 8, 4, 2, 1) over lanes of (warps, 32)."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        parts = _merge(parts, tuple(p[:, lanes ^ off] for p in parts))
    return parts


def _block_add(state, mask, a, b):
    """The block form's update of the threads in ``mask`` with their
    (threads, N) scaled logits: the vector's max first, (st, acc) or ss
    rescaled once when it moves, then one exp2 an element a tensor."""
    mt, st, acc, ms, ss, mt2, ms2 = state
    vt, vs = a.max(axis=1), b.max(axis=1)
    up = mask & (vt > mt)
    c = np.exp(np.where(up, mt - vt, _F(0)))
    st, acc = st * c, acc * c
    mt, mt2 = np.where(up, vt, mt), np.where(up, vt * _LOG2E, mt2)
    up = mask & (vs > ms)
    ss = ss * np.exp(np.where(up, ms - vs, _F(0)))
    ms, ms2 = np.where(up, vs, ms), np.where(up, vs * _LOG2E, ms2)
    with np.errstate(over="ignore", invalid="ignore"):   # threads off the
        for i in range(a.shape[1]):                    # mask: discarded
            e = np.exp2(_fma(a[:, i], _LOG2E, -mt2))
            st = np.where(mask, st + e, st)
            acc = np.where(mask, _fma(e, a[:, i] - b[:, i], acc), acc)
            ss = np.where(mask, ss + np.exp2(_fma(b[:, i], _LOG2E, -ms2)),
                          ss)
    return mt, st, acc, ms, ss, mt2, ms2


def _warp_add(state, mask, a, b):
    """The first form's branch-free update, one element a lane."""
    mt, st, acc, ms, ss = state
    a, b = a[:, 0], b[:, 0]
    mt_n = np.maximum(mt, a)
    c, e = np.exp(mt - mt_n), np.exp(a - mt_n)
    ms_n = np.maximum(ms, b)
    new = (mt_n, st * c + e, acc * c + e * (a - b), ms_n,
           ss * np.exp(ms - ms_n) + np.exp(b - ms_n))
    return tuple(np.where(mask, n, o) for n, o in zip(new, state))


def mirror_row(t, s, inv_temp, threads, width, form, offset):
    """One row of B1 (``t``, ``s`` its (V,) fp32 logits) as the kernel
    computes it; ``offset``: the row start's element offset past a 16-byte
    boundary (the block form peels ``(width - offset) % width``)."""
    v = t.shape[0]
    tid = np.arange(threads)
    init = (np.full(threads, _NEG_INIT), np.zeros(threads, _F),
            np.zeros(threads, _F), np.full(threads, _NEG_INIT),
            np.zeros(threads, _F))
    if form == "warp":
        state, add, head, nvec = init, _warp_add, 0, 0
    else:
        state = init + (np.full(threads, _NEG_INIT * _LOG2E),) * 2
        add = _block_add
        head = min((width - offset % width) % width, v)
        nvec = (v - head) // width

    def gather(x, idx):
        vals = np.where(idx < v, x[np.minimum(idx, v - 1)], _F(0))
        return vals.reshape(threads, width) * inv_temp

    def scalars(j):
        ok = j < v
        jj = np.minimum(j, v - 1)[:, None]
        return ok, t[jj] * inv_temp, s[jj] * inv_temp

    if head:
        state = add(state, *scalars(np.where(tid < head, tid, v)))
    for k in range(0, nvec, threads):
        vec = k + tid
        ok = vec < nvec
        idx = (head + vec[:, None] * width + np.arange(width)).reshape(-1)
        idx = np.where(np.repeat(ok, width), idx, v)
        state = add(state, ok, gather(t, idx), gather(s, idx))
    start = head + nvec * width
    for k in range(start, v, threads):
        state = add(state, *scalars(k + tid))
    parts = tuple(p.reshape(-1, 32) for p in state[:5])
    parts = _warp_merge(parts)
    lead = tuple(p[:, 0] for p in parts)             # each warp's lane 0
    empty = (_NEG_INIT, _F(0), _F(0), _NEG_INIT, _F(0))
    parts = tuple(np.concatenate([p, np.full(32 - len(p), e, _F)])[None]
                  for p, e in zip(lead, empty))       # warp 0's lanes
    mt, st, acc, ms, ss = (p[0, 0] for p in _warp_merge(parts))
    lse_t, lse_s = mt + np.log(st), ms + np.log(ss)
    return acc / st - lse_t + lse_s, lse_t, lse_s


def mirror_kd_kl_fwd(lt, ls, temp, threads, width, form, offset):
    """(T, V) fp32 -> (kl, lse_t, lse_s) as kd_kl.cu's B1 computes them,
    with the first row ``offset`` elements past a 16-byte boundary."""
    inv_temp, temp_sq = _F(1.0 / temp), _F(temp * temp)
    v = lt.shape[1]
    rows = [mirror_row(t, s, inv_temp, threads, width, form,
                       (offset + r * v) % width)
            for r, (t, s) in enumerate(zip(lt, ls))]
    kl, lse_t, lse_s = (np.array(x, _F) for x in zip(*rows))
    return kl * temp_sq, lse_t, lse_s


@functools.lru_cache(maxsize=None)
def _reference_fwd(v, temp):
    """Inputs of 5 rows (a constant teacher row, a row where the student
    equals the teacher, three drawn) and the reference's Pallas forward on
    them in interpret mode: (lt, ls, kl, lse_t, lse_s)."""
    rng = np.random.default_rng(v * 10 + int(temp))
    lt = (rng.standard_normal((5, v)) * 2).astype(_F)
    ls = (rng.standard_normal((5, v)) * 2).astype(_F)
    lt[0] = 0.75
    ls[1] = lt[1]
    kl, lse_t, lse_s = jax_ops._fwd_impl(jnp.asarray(lt), jnp.asarray(ls),
                                         temp, 16, 128, True)
    return lt, ls, *(np.asarray(x)[:5] for x in (kl, lse_t, lse_s))


@pytest.mark.parametrize("temp", TEMPS)
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("v", [1, 5, 37, 1027])
def test_kd_kl_fwd_mirror_matches_reference_kernel(v, offset, temp):
    """The mirror of B1 in every form, with the first row ``offset``
    elements past a 16-byte boundary (ragged heads, bodies and tails;
    threads, lanes and warps left empty), against the reference's Pallas
    forward (``kd_kl_loss``'s, in interpret mode) at 1e-5; where the
    student equals the teacher the KL is 0 within it."""
    lt, ls, *want = _reference_fwd(v, temp)
    for threads, width, form in MIRROR_FORMS:
        got = mirror_kd_kl_fwd(lt, ls, temp, threads, width, form, offset)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL,
                                       err_msg=f"{form} {threads}x{width}")
        assert abs(float(got[0][1])) <= TOL
