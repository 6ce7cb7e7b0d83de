"""The port's client-batched conv against the reference's, on the CPU.

Forward against the reference's Pallas kernel in interpret mode (as its
own tests run it), and the input and filter gradients against its custom
VJP, within 1e-5 absolute in fp32.  The cases are every conv geometry of
ResNet-8 at width 16 (K=3 clients, N=2 examples), including the stride-2
SAME convs whose pads are asymmetric (0 before, 1 after), a K=1 case, an
odd input size and a VALID case.  The CUDA kernel is held against the
plain version on the card by ``test_torch_gpu.py``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.grouped_conv import ops as jax_ops  # noqa: E402
from repro_torch.kernels.grouped_conv import ops, ref  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# (K, N, H, Cin, Cout, k, stride, padding)
RESNET8 = [
    (3, 2, 32, 3, 16, 3, 1, "SAME"),     # stem
    (3, 2, 32, 16, 16, 3, 1, "SAME"),    # block1.conv1 / conv2
    (3, 2, 32, 16, 32, 3, 2, "SAME"),    # block2.conv1, pads 0/1
    (3, 2, 16, 32, 32, 3, 1, "SAME"),    # block2.conv2
    (3, 2, 32, 16, 32, 1, 2, "SAME"),    # block2.proj
    (3, 2, 16, 32, 64, 3, 2, "SAME"),    # block3.conv1, pads 0/1
    (3, 2, 8, 64, 64, 3, 1, "SAME"),     # block3.conv2
    (3, 2, 16, 32, 64, 1, 2, "SAME"),    # block3.proj
]
EXTRA = [
    (1, 3, 16, 16, 32, 3, 2, "SAME"),    # K=1: the single-client route
    (2, 2, 9, 4, 8, 3, 2, "SAME"),       # odd H: pads 1/1
    (2, 2, 11, 4, 4, 3, 2, "VALID"),     # VALID with a non-dividing stride
]
TOL = 1e-5


def _ids(c):
    return f"K{c[0]}H{c[2]}c{c[3]}-{c[4]}k{c[5]}s{c[6]}{c[7]}"


def _case(seed, K, N, H, Cin, Cout, kh, stride, padding):
    rng = np.random.default_rng(seed)
    oh = ref.resolve_pads(H, kh, stride, padding)[0]
    # He-scaled filters and a cotangent scaled by 1/sqrt(N·OH·OW) keep y, dx
    # and dw all O(1), where fp32 resolves the 1e-5 absolute bar
    x = rng.standard_normal((K, N, H, H, Cin)).astype(np.float32)
    w = (rng.standard_normal((K, kh, kh, Cin, Cout))
         / np.sqrt(kh * kh * Cin)).astype(np.float32)
    dy = (rng.standard_normal((K, N, oh, oh, Cout))
          / np.sqrt(N * oh * oh)).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("case", RESNET8 + EXTRA, ids=_ids)
def test_conv_and_gradients_match_reference(case):
    K, N, H, Cin, Cout, kh, s, pad = case
    x, w, dy = _case(sum(case[:6]), *case)

    def jax_obj(x_, w_):
        y = jax_ops.client_batched_conv(x_, w_, stride=s, padding=pad,
                                        use_pallas=True, interpret=True)
        return jnp.sum(y * dy), y

    (_, jy), (jdx, jdw) = jax.jit(jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True))(x, w)

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = ops.client_batched_conv(tx, tw, stride=s, padding=pad)
    (y * torch.from_numpy(dy)).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                               rtol=0, atol=TOL)


def test_same_pads_are_asymmetric_like_jax():
    assert ref.same_pads(32, 3, 2) == (16, 0, 1)
    assert ref.same_pads(32, 1, 2) == (16, 0, 0)
    assert ref.same_pads(9, 3, 2) == (5, 1, 1)
    assert ref.same_pads(32, 3, 1) == (32, 1, 1)


def test_rejects_mismatched_clients():
    with pytest.raises(ValueError, match="client axes"):
        ops.client_batched_conv(torch.zeros(2, 1, 4, 4, 3),
                                torch.zeros(3, 3, 3, 3, 8))


# The CUDA kernel's tile plan (``ops.conv_plan``), which the wrapper makes
# on the host: (H, Cin, Cout, k, stride) of ResNet-8's nine convs at width
# 16 on 32x32, taken at K=4, N=64 (a local step) and K=1 at N=256, 1024
# and 788 (evaluation and the teacher precompute's chunks), and of the
# reference's ResNet-50 on 64x64 inputs (stem, then the bottleneck stages
# at 16, 8, 4 and 2 pixels, up to 2048 channels), at K=4, N=64
RESNET8_PLAN = [(32, 3, 16, 3, 1), (32, 16, 16, 3, 1), (32, 16, 32, 3, 2),
                (16, 32, 32, 3, 1), (32, 16, 32, 1, 2), (16, 32, 64, 3, 2),
                (8, 64, 64, 3, 1), (16, 32, 64, 1, 2)]
RESNET50_PLAN = [(64, 3, 64, 7, 2),
                 (16, 64, 64, 1, 1), (16, 64, 64, 3, 1), (16, 64, 256, 1, 1),
                 (16, 256, 64, 1, 1),
                 (16, 256, 128, 1, 1), (16, 128, 128, 3, 2), (8, 128, 512, 1, 1),
                 (16, 256, 512, 1, 2), (8, 512, 128, 1, 1), (8, 128, 128, 3, 1),
                 (8, 512, 256, 1, 1), (8, 256, 256, 3, 2), (4, 256, 1024, 1, 1),
                 (8, 512, 1024, 1, 2), (4, 1024, 256, 1, 1), (4, 256, 256, 3, 1),
                 (4, 1024, 512, 1, 1), (4, 512, 512, 3, 2), (2, 512, 2048, 1, 1),
                 (4, 1024, 2048, 1, 2), (2, 2048, 512, 1, 1), (2, 512, 512, 3, 1)]
PLAN_CASES = ([(4, 64) + g for g in RESNET8_PLAN]
              + [(1, n) + g for n in (256, 1024, 788) for g in RESNET8_PLAN]
              + [(4, 64) + g for g in RESNET50_PLAN]
              + [(2, 3, 9, 4, 8, 3, 2), (3, 5, 7, 8, 24, 3, 1),
                 (2, 4, 16, 32, 128, 3, 1), (1, 2, 64, 3, 64, 7, 2)])


def _covered(plan, n, oh, ow):
    """Every (image, row, col) output pixel a block writes, decoding the
    grid's x index and the block's 128 pixels as the kernel does."""
    nrb = -(-oh // plan.tile_rows)
    ncb = -(-ow // plan.tile_cols)
    seen = np.zeros((n, oh, ow), np.int64)
    for bx in range(plan.grid[0]):
        cb, rest = bx % ncb, bx // ncb
        rb, nb = rest % nrb, rest // nrb
        img0 = nb * plan.tile_imgs
        oh0, ow0 = rb * plan.tile_rows, cb * plan.tile_cols
        for p in range(ops.TILE_PIXELS):
            pc, q = p % plan.tile_cols, p // plan.tile_cols
            pr, pi = q % plan.tile_rows, q // plan.tile_rows
            if (pi < plan.tile_imgs and img0 + pi < n and oh0 + pr < oh
                    and ow0 + pc < ow):
                seen[img0 + pi, oh0 + pr, ow0 + pc] += 1
    return seen


# every case SAME, and VALID where the input is at least the filter
PLAN_PADS = [(c, p) for c in PLAN_CASES for p in ("SAME", "VALID")
             if p == "SAME" or c[2] >= c[5]]


@pytest.mark.parametrize("case,pad", PLAN_PADS, ids=str)
def test_conv_plan_fits_and_covers_every_output(case, pad):
    k, n, h, cin, cout, kk, s = case
    plan = ops.conv_plan(k, n, h, h, cin, cout, kk, kk, s, pad)
    oh = ref.resolve_pads(h, kk, s, pad)[0]
    # the kernel's tiles: <= 128 pixels, whole images only as whole rows
    # and columns, a Cin chunk of at most 32, shared memory within a block's
    assert plan.tile_imgs * plan.tile_rows * plan.tile_cols <= ops.TILE_PIXELS
    if plan.tile_imgs > 1:
        assert (plan.tile_rows, plan.tile_cols) == (oh, oh)
    assert 1 <= plan.chunk <= min(cin, ops.MAX_CHUNK)
    assert plan.stages in (1, 2) and (plan.stages == 1 or plan.chunk < cin)
    assert plan.smem_bytes <= ops.MAX_SMEM == 227 * 1024
    # the bytes the kernel recounts: the offset table, then per stage the
    # receptive window (channel stride 4 mod 8) and the padded filter slice
    kp = -(-kk * kk * plan.chunk // 8) * 8
    window = (plan.tile_imgs * ((plan.tile_rows - 1) * s + kk)
              * ((plan.tile_cols - 1) * s + kk) * ops.channel_stride(plan.chunk))
    assert ops.channel_stride(plan.chunk) % 8 == 4
    assert plan.smem_bytes == 4 * (kp + plan.stages * (window + kp * (plan.bn + 8)))
    # every output channel and client, every pixel exactly once
    assert plan.bn in (8, 16, 32, 64) and plan.grid[1] * plan.bn >= cout
    assert (plan.grid[1] - 1) * plan.bn < cout and plan.grid[2] == k
    assert (_covered(plan, n, oh, oh) == 1).all()


def test_conv_plan_tiles_resnet8_as_designed():
    """Whole output rows, ~128 pixels: 4 x 32 at 32x32, 8 x 16 at 16x16,
    two images at 8x8; the stem's Cin = 3 in one chunk."""
    stem = ops.conv_plan(4, 64, 32, 32, 3, 16, 3, 3, 1, "SAME")
    assert (stem.tile_imgs, stem.tile_rows, stem.tile_cols) == (1, 4, 32)
    assert (stem.chunk, stem.bn, stem.stages, stem.grid) == (3, 16, 1, (512, 1, 4))
    b2 = ops.conv_plan(1, 1024, 16, 16, 32, 32, 3, 3, 1, "SAME")
    assert (b2.tile_imgs, b2.tile_rows, b2.tile_cols) == (1, 8, 16)
    b3 = ops.conv_plan(1, 788, 8, 8, 64, 64, 3, 3, 1, "SAME")
    assert (b3.tile_imgs, b3.tile_rows, b3.tile_cols) == (2, 8, 8)
    assert b3.grid == (394, 1, 1) and b3.stages == 2


def test_conv_plan_raises_where_no_tile_fits():
    with pytest.raises(ValueError, match="no tile plan fits"):
        ops.conv_plan(1, 1, 4096, 4096, 3, 64, 101, 101, 1, "SAME")
    with pytest.raises(ValueError, match="no output"):
        ops.conv_plan(1, 1, 2, 2, 8, 8, 3, 3, 1, "VALID")
