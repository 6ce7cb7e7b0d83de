"""The client-batched conv's weight-gradient kernel, on the CPU.

The kernel (``csrc/grouped_conv.cu grouped_conv_dw_f32``) runs only on a
card, where ``test_torch_gpu.py`` holds it to ``ref.shift_gemm_dw``.  Here:
its plan (``ops.conv_dw_plan``) at ResNet-8's convs at every cohort size
the port trains (K = 1-4, N = 64), at ResNet-50's distinct shapes and at
VALID cases; a mirror of the kernel's index math (the pixel table, the
rows' window offsets, the staging's zero fill, the splits and their sum)
against the plain version; the operator on CPU tensors and under
``torch.func.vmap`` of ``grad``; and its cost against the benchmark's own
pricing of the same work.
"""
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.grouped_conv import ops, ref  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models.resnet import resnet50_convs  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
SMS = 132

# (H, Cin, Cout, k, stride) of ResNet-8's nine convs at width 16 on 32x32
# (block1's two convs share a shape)
RESNET8 = [(32, 3, 16, 3, 1), (32, 16, 16, 3, 1), (32, 16, 32, 3, 2),
           (16, 32, 32, 3, 1), (32, 16, 32, 1, 2), (16, 32, 64, 3, 2),
           (8, 64, 64, 3, 1), (16, 32, 64, 1, 2)]
# ResNet-50's 23 distinct shapes at 64x64 inputs
RESNET50 = sorted({tuple(c[1:]) for c in resnet50_convs(64)})
# (K, N, H, Cin, Cout, k, stride, padding): the plan's cases past the
# networks' (VALID, odd sizes, Cout past a tile)
EXTRA = [(2, 3, 11, 4, 4, 3, 2, "VALID"), (3, 5, 9, 8, 24, 3, 1, "VALID"),
         (1, 2, 64, 3, 64, 7, 2, "VALID"), (2, 3, 9, 4, 8, 3, 2, "SAME"),
         (2, 4, 16, 32, 128, 3, 1, "SAME")]
PLAN_CASES = ([(k, 64) + g + ("SAME",) for k in (1, 2, 3, 4) for g in RESNET8]
              + [(4, 64) + g + ("SAME",) for g in RESNET50] + EXTRA)


def _frozen_roofline():
    """The benchmark's frozen pricing, loaded from its file (it imports
    nothing)."""
    path = ROOT / "cardbench" / "frozen" / "roofline.py"
    spec = importlib.util.spec_from_file_location("frozen_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_conv_dw_plan_fits_the_kernel(case):
    k, n, h, cin, cout, kk, s, pad = case
    plan = ops.conv_dw_plan(k, n, h, h, cin, cout, kk, kk, s, pad)
    oh = ref.resolve_pads(h, kk, s, pad)[0]
    # the pixel tile: <= 128 pixels, whole images only as whole rows and
    # columns; the tiles cover the client's pixels, each split takes some
    tpix = plan.tile_imgs * plan.tile_rows * plan.tile_cols
    assert tpix <= ops.TILE_PIXELS
    if plan.tile_imgs > 1:
        assert (plan.tile_rows, plan.tile_cols) == (oh, oh)
    assert plan.ntiles == (-(-n // plan.tile_imgs) * -(-oh // plan.tile_rows)
                           * -(-oh // plan.tile_cols))
    assert 1 <= plan.splits <= plan.ntiles
    assert plan.stages in (1, 2)
    # a block's rows fit its 4 warps' m16 tiles (16 / (bn / 8) a warp); a
    # chunk short of Cin is a multiple of 4 where it can be, and as small
    # as its number of chunks allows (the chunks as even as they can be)
    assert plan.bn in (8, 16, 32) and 1 <= plan.chunk <= cin
    assert -(-kk * kk * plan.chunk // 16) <= 4 * (16 // (plan.bn // 8))
    chunks = -(-cin // plan.chunk)
    if plan.chunk < cin and plan.chunk >= 4:
        assert plan.chunk % 4 == 0
        assert plan.chunk == 4 or -(-cin // (plan.chunk - 4)) > chunks
    # the grid: chunks x channel tiles, splits, clients, within CUDA's limits
    tiles = -(-cout // plan.bn)
    assert plan.grid == (chunks * tiles, plan.splits, k)
    assert plan.grid[0] < 2 ** 31 and plan.grid[1] <= 65535 and k <= 65535
    # the shared memory the kernel recounts: the pixel table, then per stage
    # the window and dy's rows
    kpix = -(-tpix // 8) * 8
    ws = 1 if kk == 1 else s       # a 1x1 window holds just the tile's pixels
    window = (plan.tile_imgs * ((plan.tile_rows - 1) * ws + kk)
              * ((plan.tile_cols - 1) * ws + kk)
              * ops.dw_channel_stride(plan.chunk, ws))
    assert plan.smem_bytes == 4 * (ops.TILE_PIXELS + plan.stages * (
        window + kpix * ops.dw_row_stride(plan.bn)))
    assert plan.smem_bytes <= ops.MAX_SMEM == 232_448
    # the splits' partials: at most twice x's bytes, none for one split
    x_elems = k * n * h * h * cin
    assert plan.scratch <= 2 * x_elems
    assert plan.scratch == (0 if plan.splits == 1
                            else plan.splits * k * kk * kk * cin * cout)
    # one split where the output tiles alone give two blocks an SM, and
    # enough splits to give them where the pixels and the scratch allow
    if chunks * tiles * k >= 2 * SMS:
        assert plan.splits == 1
    elif plan.splits * chunks * tiles * k < 2 * SMS:
        assert (plan.splits == max(1, plan.ntiles // ops.DW_MIN_TILES)
                or (plan.splits + 1) * kk * kk * cout > 2 * n * h * h)


def test_conv_dw_plan_at_resnet8_as_designed():
    """The cell's step: the first block's 65,536 pixels a client in 66
    splits, two blocks an SM; block 3's 3x3 conv at 24 channels a chunk
    (its 64 in three chunks; 28, the most its rows hold, would leave 8)."""
    b1 = ops.conv_dw_plan(4, 64, 32, 32, 16, 16, 3, 3, 1, "SAME")
    assert (b1.tile_imgs, b1.tile_rows, b1.tile_cols) == (1, 4, 32)
    assert (b1.chunk, b1.bn, b1.splits, b1.grid) == (16, 16, 66, (1, 66, 4))
    b3 = ops.conv_dw_plan(4, 64, 8, 8, 64, 64, 3, 3, 1, "SAME")
    assert (b3.chunk, b3.bn, b3.grid) == (24, 32, (6, 11, 4))
    assert b1.smem_bytes <= ops.DW_SMEM and b3.smem_bytes <= ops.DW_SMEM


@pytest.mark.parametrize("shape", [g for g in RESNET50 if g[3] == 1]
                         + [(16, 32, 64, 1, 2)], ids=str)
def test_conv_dw_plan_fills_a_blocks_rows_at_1x1(shape):
    """A 1x1 conv's chunk takes as many channels as the block's 4 warps'
    m16 tiles hold (256 at 32 output channels a tile), or all of Cin,
    and its tile shrinks to make room: no warp idles where Cin allows."""
    h, cin, cout, kk, s = shape
    plan = ops.conv_dw_plan(4, 64, h, h, cin, cout, kk, kk, s, "SAME")
    assert plan.bn == 32 and plan.chunk == min(cin, 256)
    assert plan.tile_imgs * plan.tile_rows * plan.tile_cols >= ops.DW_MIN_PIXELS
    assert plan.smem_bytes <= ops.DW_SMEM and plan.stages == 2


def test_conv_dw_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="more taps"):
        ops.conv_dw_plan(1, 1, 64, 64, 3, 32, 17, 17, 1, "SAME")
    with pytest.raises(ValueError, match="no output"):
        ops.conv_dw_plan(1, 1, 2, 2, 8, 8, 3, 3, 1, "VALID")


def mirror_conv_dw(x: np.ndarray, dy: np.ndarray, stride: int, kh: int,
                   kw: int, padding: str) -> np.ndarray:
    """The kernel's arithmetic in float64, indexed as the kernel indexes:
    block by block of its plan's grid, each pixel tile's window and dy rows
    staged into buffers whose unstaged slots are NaN (a read of one poisons
    the result), the reduction's operands read through the pixel table and
    the rows' offsets, the splits' partials summed in split order."""
    k_, n, h, w, cin = x.shape
    oh, ow, cout = dy.shape[2:]
    plan = ops.conv_dw_plan(k_, n, h, w, cin, cout, kh, kw, stride, padding)
    _, pt, _ = ref.resolve_pads(h, kh, stride, padding)
    _, pl, _ = ref.resolve_pads(w, kw, stride, padding)
    ti, tr, tc, cc, bn = (plan.tile_imgs, plan.tile_rows, plan.tile_cols,
                          plan.chunk, plan.bn)
    step, ws = ops.dw_window_steps(kh, kw, stride)
    wr, wc = (tr - 1) * ws + kh, (tc - 1) * ws + kw
    ccp, dyp = ops.dw_channel_stride(cc, ws), ops.dw_row_stride(bn)
    tpix = ti * tr * tc
    kpix = -(-tpix // 8) * 8
    nrb, ncb = -(-oh // tr), -(-ow // tc)
    p = np.arange(ops.TILE_PIXELS)
    pc, pr, pi = p % tc, (p // tc) % tr, p // tc // tr
    ptab = np.where(pi < ti, ((pi * wr + pr * ws) * wc + pc * ws) * ccp, 0)
    mtb = -(-kh * kw * cc // 16)
    r = np.arange(16 * mtb)
    tap, c = r // cc, r % cc
    im_, wr_, wc_, ch_ = np.meshgrid(np.arange(ti), np.arange(wr),
                                     np.arange(wc), np.arange(cc),
                                     indexing="ij")
    dw_elems = kh * kw * cin * cout
    part = np.full((k_, plan.splits, dw_elems), np.nan)
    chunks, tiles = -(-cin // cc), -(-cout // bn)
    for k, chunk, ct, sp in itertools.product(range(k_), range(chunks),
                                              range(tiles), range(plan.splits)):
        c0, co0 = chunk * cc, ct * bn
        row = (r < kh * kw * cc) & (c0 + c < cin)
        off = np.where(row, ((tap // kw) * wc + tap % kw) * ccp + c, 0)
        acc = np.zeros((16 * mtb, bn))
        t0 = sp * plan.ntiles // plan.splits
        t1 = (sp + 1) * plan.ntiles // plan.splits
        for t in range(t0, t1):
            cb, rb, nb = t % ncb, t // ncb % nrb, t // ncb // nrb
            img0, oh0, ow0 = nb * ti, rb * tr, cb * tc
            win = np.full(ti * wr * wc * ccp, np.nan)
            ih = oh0 * stride - pt + wr_ * step
            iw = ow0 * stride - pl + wc_ * step
            img = img0 + im_
            inside = ((img < n) & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
                      & (c0 + ch_ < cin))
            vals = np.where(inside, x[k, np.minimum(img, n - 1),
                                      np.clip(ih, 0, h - 1),
                                      np.clip(iw, 0, w - 1),
                                      np.minimum(c0 + ch_, cin - 1)], 0.0)
            win[((im_ * wr + wr_) * wc + wc_) * ccp + ch_] = vals
            dys = np.full((kpix, dyp), np.nan)
            q = np.arange(kpix)
            qc, qr, qi = q % tc, (q // tc) % tr, q // tc // tr
            co = co0 + np.arange(bn)
            valid = ((q < tpix) & (img0 + qi < n) & (oh0 + qr < oh)
                     & (ow0 + qc < ow))[:, None] & (co < cout)[None, :]
            dys[:, :bn] = np.where(valid, dy[k, np.minimum(img0 + qi, n - 1)[:, None],
                                             np.minimum(oh0 + qr, oh - 1)[:, None],
                                             np.minimum(ow0 + qc, ow - 1)[:, None],
                                             np.minimum(co, cout - 1)[None, :]],
                                   0.0)
            a = win[ptab[:kpix][None, :] + off[:, None]]
            acc += a @ dys[:, :bn]
        grow = tap * cin + c0 + c
        for j in range(bn):
            if co0 + j < cout:
                part[k, sp, grow[row] * cout + co0 + j] = acc[row, j]
    return part.sum(axis=1).reshape(k_, kh, kw, cin, cout)


# (K, N, H, Cin, Cout, k, stride, padding): several splits, several Cin
# chunks with a partial last one, channel tiles with a partial last one,
# whole-image tiles with a ragged last one, the stem's 7x7 stride 2 over
# Cin = 3, 1x1 stride 2 (its window strided over the input), VALID with a
# stride that does not divide, 1x1 chunks past 32 channels (a partial last
# one of 256 + 4, the tile cut to 32 pixels), a 3x3 tile cut to fewer
# images for a chunk of 28
MIRROR = [(1, 8, 16, 3, 16, 3, 1, "SAME"), (2, 8, 8, 40, 20, 3, 1, "SAME"),
          (1, 32, 8, 8, 40, 3, 2, "SAME"), (2, 5, 7, 8, 24, 3, 1, "SAME"),
          (1, 2, 16, 3, 8, 7, 2, "SAME"), (3, 4, 10, 16, 32, 1, 2, "SAME"),
          (2, 3, 11, 4, 4, 3, 2, "VALID"), (1, 6, 12, 5, 6, 3, 1, "SAME"),
          (1, 8, 7, 260, 40, 1, 2, "SAME"), (2, 2, 9, 72, 33, 1, 1, "SAME"),
          (1, 40, 4, 64, 32, 3, 2, "SAME")]


@pytest.mark.parametrize("case", MIRROR, ids=str)
def test_kernel_index_mirror_equals_plain(case):
    k, n, h, cin, cout, kk, s, pad = case
    rng = np.random.default_rng(sum(case[:7]))
    oh = ref.resolve_pads(h, kk, s, pad)[0]
    x = rng.standard_normal((k, n, h, h, cin))
    dy = rng.standard_normal((k, n, oh, oh, cout))
    want = ref.shift_gemm_dw(torch.from_numpy(x), torch.from_numpy(dy), s, kk,
                             kk, pad).numpy()
    got = mirror_conv_dw(x, dy, s, kk, kk, pad)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * max(1.0, np.abs(want).max()))


def test_kernel_index_mirror_splits_the_pixels():
    """The mirror's cases reach the kernel's branches: splits, chunks."""
    plans = [ops.conv_dw_plan(c[0], c[1], c[2], c[2], c[3], c[4], c[5], c[5],
                              c[6], c[7]) for c in MIRROR]
    assert max(p.splits for p in plans) > 1
    assert any(p.grid[0] > 1 and p.splits > 1 for p in plans)
    assert any(p.tile_imgs > 1 and p.splits > 1 for p in plans)
    assert any(p.chunk > ops.MAX_CHUNK and p.grid[0] > 2 for p in plans)


def _inputs(seed, k, n, h, cin, cout, kk, s, pad):
    gen = torch.Generator().manual_seed(seed)
    oh = ref.resolve_pads(h, kk, s, pad)[0]
    return (torch.randn(k, n, h, h, cin, generator=gen),
            torch.randn(k, n, oh, oh, cout, generator=gen))


@pytest.mark.parametrize("case", [(4, 2, 32, 3, 16, 3, 1, "SAME"),
                                  (3, 2, 16, 32, 64, 3, 2, "SAME"),
                                  (2, 3, 11, 4, 4, 3, 2, "VALID")], ids=str)
def test_operator_on_cpu_is_the_plain_version(case):
    k, n, h, cin, cout, kk, s, pad = case
    x, dy = _inputs(sum(case[:7]), *case)
    got = ops.grouped_conv_dw(x, dy, s, kk, kk, pad)
    assert torch.equal(got, ref.shift_gemm_dw(x, dy, s, kk, kk, pad))
    assert got.is_contiguous()


def test_operator_refuses_a_dy_of_another_conv():
    x, dy = _inputs(0, 2, 2, 8, 4, 8, 3, 1, "SAME")
    with pytest.raises(ValueError, match="pixels"):
        ops.grouped_conv_dw(x, dy, 2, 3, 3, "SAME")


@pytest.mark.parametrize("shape", [(16, 32, 64, 3, 2), (8, 16, 8, 1, 1)],
                         ids=str)
def test_weight_gradient_under_vmap_of_grad(shape):
    """``vmap(grad)`` of a single-client conv over 4 clients: the weight
    gradient's Function folds the vmapped axis into K, and dw is the plain
    version's."""
    from torch.func import grad, vmap

    h, cin, cout, kk, s = shape
    x, dy = _inputs(12, 4, 3, h, cin, cout, kk, s, "SAME")
    w = torch.randn(4, kk, kk, cin, cout) / (kk * kk * cin) ** 0.5

    def one(xi, wi, dyi):
        return torch.sum(ops.client_batched_conv(xi[None], wi[None],
                                                 stride=s)[0] * dyi)

    dw = vmap(grad(one, argnums=1))(x, w, dy)
    torch.testing.assert_close(dw, ref.shift_gemm_dw(x, dy, s, kk, kk, "SAME"),
                               rtol=0, atol=1e-6)


def test_second_derivative_of_the_weight_gradient_raises():
    x, dy = _inputs(1, 1, 2, 6, 4, 4, 3, 1, "SAME")
    dy.requires_grad_(True)
    dw = ops._ConvDw.apply(x, dy, 1, 3, 3, "SAME")
    with pytest.raises(RuntimeError, match="no derivative"):
        dw.sum().backward()


@pytest.mark.parametrize("k,n", [(4, 64), (1, 64), (2, 64), (3, 64), (1, 256)])
def test_dw_cost_prices_the_benchmarks_work(k, n):
    frozen = _frozen_roofline()
    for h, cin, cout, kk, s in RESNET8:
        cost = roofline.grouped_conv_dw_cost(k, n, h, h, cin, cout, kk, kk, s)
        assert cost.nbytes == frozen.conv_dw_bytes(k, n, h, cin, cout, kk, s)
        assert cost.flops == frozen.conv_flops(k * n, h, cin, cout, kk, s)
    # the forward's work, which the gradient's products repeat
    fwd = roofline.grouped_conv_cost(k, n, 32, 16, 16, 3, 1)
    assert roofline.grouped_conv_dw_cost(k, n, 32, 32, 16, 16, 3, 3, 1) == fwd


def test_dry_run_counts_the_operator_by_its_cost():
    """On the meta device the operator gives dw's shape, and the dry-run's
    counters price it by the cost with the plan's scratch."""
    x = torch.empty(4, 64, 32, 32, 16, device="meta")
    dy = torch.empty(4, 64, 32, 32, 16, device="meta")
    dw = ops.grouped_conv_dw(x, dy, 1, 3, 3)
    assert dw.shape == (4, 3, 3, 16, 16) and dw.device.type == "meta"
    cost = roofline.kernel_cost(torch.ops.repro_torch.grouped_conv_dw,
                                (x, dy, 1, 3, 3, "SAME"), dw)
    plan = ops.conv_dw_plan(4, 64, 32, 32, 16, 16, 3, 3, 1, "SAME")
    assert cost == roofline.grouped_conv_dw_cost(
        4, 64, 32, 32, 16, 16, 3, 3, 1)._replace(scratch=4.0 * plan.scratch)
