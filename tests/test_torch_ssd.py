"""The port's SSD scan against the JAX package, on the CPU.

``repro_torch.kernels.ssd_scan.ops.ssd_scan`` takes its plain version on
CPU tensors (the chunked dual form, ``ref.ssd_chunked``); it is held to the
reference's Pallas ``ssd_scan`` run in interpret mode and to the O(L)
recurrence ``ssd_reference``, y and final state, at the shapes of
``tests/test_kernels_ssd.py`` (the ragged pad path included) and with two
B/C groups; its x/dt/A/B/C gradients to ``jax.grad`` through the
reference's custom VJP.  Inputs come from numpy with a seed.

Tolerance: 1e-5 of the reference's largest magnitude (fp32; the chunked
and sequential forms sum in different orders, and the decays' cumsums
reach ~-100 at these shapes, where fp32 keeps ~1e-5 absolute).
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.ssd_scan import ops as jax_ops  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_chunked  # noqa: E402
from repro.models.ssm import ssd_reference as jax_sequential  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402

REL_TOL = 1e-5

SHAPES = [
    (2, 64, 4, 8, 1, 16, 16),
    (1, 96, 2, 16, 2, 8, 32),
    (2, 128, 4, 64, 1, 128, 128),
    (1, 50, 2, 8, 1, 8, 16),        # pad path
    (2, 39, 16, 16, 1, 16, 16),     # the smoke config's Mamba-2 layer
    (1, 40, 4, 8, 2, 8, 16),        # two groups, ragged
]


def _inputs(shape, seed):
    b, l, h, p, g, n, _ = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, z = f(b, l, h, p), f(b, l, h)
    dt = np.log1p(np.exp(z)).astype(np.float32)          # softplus
    A = (-np.exp(f(h))).astype(np.float32)
    return x, dt, A, f(b, l, g, n), f(b, l, g, n)


def _close(got, want, scale=None):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL_TOL * max(scale, 1.0))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ssd_scan_matches_reference_kernel_and_recurrence(shape):
    args = _inputs(shape, seed=sum(shape))
    chunk = shape[-1]
    reset_launches()
    y, state = ops.ssd_scan(*(torch.from_numpy(a) for a in args), chunk=chunk)
    assert LAUNCHES["ssd_scan_fwd"] == 0          # CPU: the plain version
    jargs = [jnp.asarray(a) for a in args]
    jy, jstate = jax.jit(lambda *a: jax_ops.ssd_scan(
        *a, chunk=chunk, interpret=True))(*jargs)
    _close(y.numpy(), jy)
    _close(state.numpy(), jstate)
    _close(y.numpy(), jax.jit(jax_sequential)(*jargs))
    _, cstate = jax.jit(lambda *a: jax_chunked(*a, chunk=chunk))(*jargs)
    _close(state.numpy(), cstate)


def test_plain_versions_agree_in_float64():
    """The chunked form and the recurrence are one function: in float64
    they agree to rounding."""
    args = [torch.from_numpy(a).double()
            for a in _inputs((2, 50, 4, 8, 2, 8, 16), seed=3)]
    y, _ = ref.ssd_chunked(*args, chunk=16)
    assert float((y - ref.ssd_reference(*args)).abs().max()) < 1e-12


@pytest.mark.parametrize("shape", [(1, 32, 2, 8, 1, 8, 16),
                                   (2, 39, 4, 8, 2, 8, 16)], ids=str)
def test_ssd_scan_gradients_match_reference_vjp(shape):
    args = _inputs(shape, seed=7)
    chunk = shape[-1]
    rng = np.random.default_rng(11)
    b, l, h, p, _, n, _ = shape
    wy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    ws = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def jloss(*a):
        y, s = jax_ops.ssd_scan(*a, chunk=chunk, interpret=True)
        return jnp.sum(y * wy) + jnp.sum(s * ws)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in args))
    live = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, s = ops.ssd_scan(*live, chunk=chunk)
    (torch.sum(y * torch.from_numpy(wy))
     + torch.sum(s * torch.from_numpy(ws))).backward()
    for t, w in zip(live, want, strict=True):
        _close(t.grad.numpy(), w)


def test_zero_input_gives_zero_output():
    x, dt, A, B, C = _inputs((1, 40, 2, 8, 1, 8, 16), seed=5)
    y, s = ops.ssd_scan(torch.zeros(x.shape), torch.from_numpy(dt),
                        torch.from_numpy(A), torch.from_numpy(B),
                        torch.from_numpy(C), chunk=16)
    assert float(y.abs().max()) == 0.0 and float(s.abs().max()) == 0.0


def test_ssd_scan_rejects_bad_shapes():
    x, dt, A, B, C = (torch.from_numpy(a) for a in
                      _inputs((1, 8, 4, 8, 1, 8, 8), seed=1))
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt[:, :4], A, B, C, chunk=8)
    with pytest.raises(ValueError):                # 3 groups do not divide 4 heads
        ops.ssd_scan(x, dt, A, B.expand(1, 8, 3, 8), C.expand(1, 8, 3, 8),
                     chunk=8)
