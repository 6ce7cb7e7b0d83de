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
from torch_threads import one_torch_thread  # noqa: E402,F401

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


# (B, L, H, P, G, N, chunk) -> (chunks, row tiles, pc, grid): the LM
# path's step, train_4k's length, one chunk of one token, a chunk of 48,
# the largest P and N at three groups, and the smoke config's layer
PLANS = [((4, 1023, 80, 64, 1, 128, 256), (4, 4, 2, (2720, 2560, 5120))),
         ((1, 4096, 80, 64, 1, 128, 256), (16, 4, 2, (2720, 640, 5120))),
         ((2, 1, 8, 64, 1, 128, 1), (1, 1, 2, (34, 128, 16))),
         ((2, 200, 8, 64, 1, 128, 48), (5, 1, 2, (170, 128, 80))),
         ((1, 130, 6, 128, 3, 256, 256), (1, 4, 4, (78, 192, 24))),
         ((2, 39, 16, 16, 1, 16, 16), (3, 1, 1, (102, 32, 96)))]


@pytest.mark.parametrize("shape,want", PLANS, ids=str)
def test_ssd_plan_grids_and_scratch(shape, want):
    """The plan's grids cover every (batch, chunk, head) once per 64 x 64
    tile of (P, N) or of the chunk's rows, C·Bᵀ once per group and tile on
    or below the diagonal, and the state pass every state element once."""
    b, l, h, p, g, n, chunk = shape
    plan = ops.ssd_plan(*shape)
    assert (plan.chunks, plan.row_tiles, plan.pc, plan.grid) == want
    nc, nt = plan.chunks, plan.row_tiles
    assert nc * chunk >= l > (nc - 1) * chunk and nt * 64 >= chunk
    tri = nt * (nt + 1) // 2
    assert plan.states_shape == (b, nc, h, p, n)
    assert plan.cb_shape == (b, nc, g, tri, 64 * 64)
    assert plan.decay_shape == (b, nc, h)
    assert plan.grid[1] * 1024 >= b * h * p * n
    assert 32 * plan.pc >= p > 32 * (plan.pc - 1)


def test_ssd_plan_shared_memory():
    """Both tiled kernels fit a block's shared memory at every head dim,
    and the counts are the kernels' own (csrc chunk_smem_bytes,
    out_smem_bytes): the fp64 prefix sums and dt of a chunk, then two
    stages of tiles."""
    scan = 256 * (8 + 4)
    assert ops.chunk_smem_bytes() == scan + 4 * 2 * 2 * 32 * 72 == 39_936
    assert [ops.out_smem_bytes(pc) for pc in (1, 2, 3, 4)] == [
        scan + 4 * 2 * (64 + 32) * 36, scan + 4 * 2 * (64 + 64) * 36,
        scan + 4 * 2 * 64 * 100, scan + 4 * 2 * 64 * 132]
    for p in (1, 32, 33, 64, 96, 128):
        plan = ops.ssd_plan(1, 256, 4, p, 1, 256, 256)
        assert max(plan.chunk_smem, plan.out_smem) <= ops.MAX_SMEM
        assert plan.out_smem == ops.out_smem_bytes(-(-p // 32))


def test_copy16_decision_from_strides_and_pointer():
    """16-byte copies at the path's layout (x, B and C sliced from one
    (B, L, H·P + 2·G·N) tensor: row stride 5,376 floats, offsets 0, 5,120
    and 5,248), 4-byte copies where a width, a stride or the base is off
    a multiple of 4 floats or the element stride is not 1."""
    b, l, h, p, g, n = 4, 1023, 80, 64, 1, 128
    xbc = torch.empty(b, l, h * p + 2 * g * n)
    base = 4096 * 16                       # a 16-byte aligned address
    x = xbc[..., :h * p].reshape(b, l, h, p)
    bm = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
    cm = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    assert x.stride() == (l * 5376, 5376, 64, 1)
    for t, off, width in ((x, 0, p), (bm, 5120, n), (cm, 5248, n)):
        assert t.storage_offset() == off
        assert ops.copy16(base + 4 * off, t.stride(), width)
    assert not ops.copy16(base + 4, x.stride(), p)          # misaligned base
    assert not ops.copy16(base, x.stride(), 10)             # width 10
    assert not ops.copy16(base, (l * 5378, 5378, 64, 1), p)  # row stride
    assert not ops.copy16(base, (l * 5376, 5376, 64, 2), p)  # element stride
    assert ops.copy16(base, (4, 4, 4, 1), 4)


@pytest.mark.parametrize("shape", [(1, 8, 4, 129, 1, 8, 8),
                                   (1, 8, 4, 8, 1, 257, 8),
                                   (1, 8, 4, 8, 1, 8, 0),
                                   (1, 8, 4, 8, 1, 8, 257),
                                   (1, 8, 4, 8, 3, 8, 8)], ids=str)
def test_ssd_plan_rejects_out_of_range(shape):
    with pytest.raises(ValueError):
        ops.ssd_plan(*shape)


def test_ssd_scan_launch_refuses_cpu_tensors():
    """The kernels' launcher never takes a CPU tensor (``ssd_scan_fwd``
    sends those to the plain version), and counts nothing."""
    args = [torch.from_numpy(a) for a in _inputs((1, 8, 4, 8, 1, 8, 8), 1)]
    reset_launches()
    with pytest.raises(ValueError, match="CPU"):
        ops.ssd_scan_launch(*args, 8)
    assert LAUNCHES["ssd_scan_fwd"] == 0


def test_entering_states_is_the_chunked_forms_recurrence():
    """``ref.entering_states`` (the yardstick of the kernels' scratch) is
    the recurrence ``ssd_chunked`` runs: its final state is the chunked
    form's, chunk 0 enters from 0 and each next state is the last one
    decayed plus the chunk's own, here checked against the O(L) recurrence
    at the chunk boundaries in float64."""
    shape = (2, 50, 4, 8, 2, 8, 16)
    args = [torch.from_numpy(a).double() for a in _inputs(shape, seed=4)]
    entering, final = ref.entering_states(*args, chunk=16)
    assert entering.shape == (2, 4, 4, 8, 8)
    _, want_final = ref.ssd_chunked(*args, chunk=16)
    assert float((final - want_final).abs().max()) < 1e-12
    assert float(entering[:, 0].abs().max()) == 0.0
    for z in (1, 2, 3):
        cut = [t if t.ndim == 1 else t[:, :16 * z] for t in args]  # A: (H,)
        _, s = ref.ssd_chunked(*cut, chunk=16)
        assert float((entering[:, z] - s).abs().max()) < 1e-12
