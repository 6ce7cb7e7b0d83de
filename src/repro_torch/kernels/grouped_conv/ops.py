"""Client-batched convolution: the CUDA forward kernel with an autograd rule.

``client_batched_conv(x, w, stride=, padding=)`` convolves K clients'
batches with K different filter stacks in one launch:

    x (K, N, H, W, Cin) (*) w (K, kh, kw, Cin, Cout) -> (K, N, OH, OW, Cout)

Forward: ``grouped_conv_fwd`` launches the kernel of
``csrc/grouped_conv.cu`` on a CUDA tensor (built at first use; a failed
launch raises) and takes ``ref.grouped_conv_ref`` on a CPU tensor.  The
kernel's tile plan (``conv_plan``: output pixels and channels of a block,
the Cin chunk staged in shared memory, the number of stages, the shared
memory and the grid) is made here, where the CPU tests reach it, and the
kernel recounts its shared memory and refuses a plan that disagrees.
Backward: the input gradient is ``ref.grouped_conv_dx``, per-tap K-batched
matmuls on either device, as the reference's custom VJP computes it outside
Pallas.  The filters' gradient is one ``repro_torch::grouped_conv_dw``
(``grouped_conv_dw``): on a CUDA tensor the split-K implicit GEMM of
``csrc/grouped_conv.cu`` (its plan, ``conv_dw_plan``: the pixel tile, the
Cin chunk, the output-channel tile and how many splits of the pixel axis
fill the card, made here from the shapes alone; the kernel recounts its
shared memory), on a CPU tensor ``ref.shift_gemm_dw``, on a meta tensor
its shape; ``launch.roofline.grouped_conv_dw_cost`` prices it.

Under ``torch.func.vmap`` (the executor's vmapped round body, the vmapped
client hooks) the Functions' vmap rules fold the vmapped axis into K: a
vmapped single-client conv, K=1, becomes one launch over every vmapped
client, forward and filters' gradient alike; dx is plain PyTorch and is
vmapped as it stands.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import trace
from repro_torch.kernels import LAUNCHES, build, define_op
from repro_torch.kernels.grouped_conv import ref
from repro_torch.launch import roofline


TILE_PIXELS = 128        # output pixels of a block (csrc kTileM: 4 warps x 32)
MAX_SMEM = 232_448       # the shared memory one block may take on sm_90
# the Cin chunk is halved (to 4 at least) until a stage, window and filter
# slice, fits in this, so that two stages and the offset table leave room
# for two blocks on an SM
STAGE_BYTES = 48 * 1024
MAX_CHUNK = 32           # Cin channels staged at once


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How ``csrc/grouped_conv.cu`` tiles one call: a block computes
    ``tile_imgs`` x ``tile_rows`` x ``tile_cols`` output pixels of one
    client (whole images only when a tile holds whole rows and columns)
    and ``bn`` output channels, staging Cin ``chunk`` channels at a time in
    ``stages`` buffers; ``grid`` is (pixel tiles, channel tiles, clients)."""
    tile_imgs: int
    tile_rows: int
    tile_cols: int
    chunk: int
    bn: int
    stages: int
    smem_bytes: int
    grid: tuple[int, int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def channel_stride(chunk: int) -> int:
    """The window's floats per pixel: a multiple of 4 that is 4 mod 8
    (csrc channel_stride), for conflict-free fragment reads."""
    c4 = _cdiv(chunk, 4) * 4
    return c4 + 4 if c4 % 8 == 0 else c4


def _stage_floats(imgs, rows, cols, chunk, bn, kh, kw, stride) -> int:
    window = (imgs * ((rows - 1) * stride + kh) * ((cols - 1) * stride + kw)
              * channel_stride(chunk))
    return window + _cdiv(kh * kw * chunk, 8) * 8 * (bn + 8)


def _pixel_tile(n: int, oh: int, ow: int) -> tuple[int, int, int]:
    """A block's box of <= 128 output pixels: whole rows, and whole images
    where an image has fewer pixels; (images, rows, cols)."""
    cols = min(ow, TILE_PIXELS)
    rows = min(oh, TILE_PIXELS // cols)
    imgs = (min(n, TILE_PIXELS // (rows * cols))
            if rows == oh and cols == ow else 1)
    return imgs, rows, cols


def _shrink_tile(tile: tuple[int, int, int], fits) -> tuple[int, int, int]:
    """The pixel tile cut until ``fits(imgs, rows, cols)``: images first,
    then rows, then columns (to 8)."""
    imgs, rows, cols = tile
    while not fits(imgs, rows, cols) and imgs > 1:
        imgs //= 2
    while not fits(imgs, rows, cols) and rows > 1:
        rows = _cdiv(rows, 2)
    while not fits(imgs, rows, cols) and cols > 8:
        cols = _cdiv(cols, 2)
    return imgs, rows, cols


def _out_size(h: int, w: int, kh: int, kw: int, stride: int, padding: str):
    oh = ref.resolve_pads(h, kh, stride, padding)[0]
    ow = ref.resolve_pads(w, kw, stride, padding)[0]
    if oh < 1 or ow < 1:
        raise ValueError(f"grouped_conv kernel: a {kh}x{kw} {padding} conv "
                         f"of {h}x{w} has no output")
    return oh, ow


def _bn(cout: int) -> int:
    return next((b for b in (8, 16, 32) if cout <= b), 64)


def conv_plan(k: int, n: int, h: int, w: int, cin: int, cout: int, kh: int,
              kw: int, stride: int, padding: str) -> ConvPlan:
    """The kernel's tiles for x (k, n, h, w, cin) and w (k, kh, kw, cin,
    cout); raises if no plan fits a block's shared memory."""
    oh, ow = _out_size(h, w, kh, kw, stride, padding)
    bn = _bn(cout)
    chunk = min(cin, MAX_CHUNK)

    def stage(imgs, rows, cols, chunk):
        return 4 * _stage_floats(imgs, rows, cols, chunk, bn, kh, kw, stride)

    imgs, rows, cols = _pixel_tile(n, oh, ow)
    while stage(imgs, rows, cols, chunk) > STAGE_BYTES and chunk > 4:
        chunk = _cdiv(chunk, 2)
    table = 4 * _cdiv(kh * kw * chunk, 8) * 8
    # the pixel tile shrinks only where one stage would not fit at all
    # (wide rows, large filters)
    imgs, rows, cols = _shrink_tile(
        (imgs, rows, cols),
        lambda i, r, c: table + stage(i, r, c, chunk) <= MAX_SMEM)
    one = stage(imgs, rows, cols, chunk)
    stages = 2 if cin > chunk and table + 2 * one <= MAX_SMEM else 1
    smem = table + stages * one
    if smem > MAX_SMEM:
        raise ValueError(
            f"grouped_conv kernel: no tile plan fits {MAX_SMEM} bytes of "
            f"shared memory for a {kh}x{kw} stride-{stride} conv of width {w}")
    grid = (_cdiv(n, imgs) * _cdiv(oh, rows) * _cdiv(ow, cols),
            _cdiv(cout, bn), k)
    return ConvPlan(imgs, rows, cols, chunk, bn, stages, smem, grid)


# the weight gradient's plan: output-channel tiles of at most DW_MAX_BN
# (a thread holds 64 accumulators at any width, so a wider tile would hold
# fewer rows); a block's two stages of pixel tiles within DW_SMEM, so that
# two blocks share an SM (a tile of several images, or a 1x1 conv's tile,
# shrinks to DW_MIN_PIXELS before the Cin chunk does); splits of the pixel
# axis until the grid holds DW_BLOCKS blocks (two for each of the H100's
# 132 SMs), each split reducing DW_MIN_TILES pixel tiles at least
DW_MAX_BN = 32
DW_SMEM = 112 * 1024
DW_BLOCKS = 2 * 132
DW_MIN_TILES = 2
DW_MIN_PIXELS = 32


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """How ``csrc/grouped_conv.cu`` tiles one weight gradient: a block
    reduces whole pixel tiles of ``tile_imgs`` x ``tile_rows`` x
    ``tile_cols`` output pixels of one client (``ntiles`` of them a client,
    spread over ``splits``) into every tap of a Cin ``chunk`` by ``bn``
    output channels, staging a tile in each of ``stages`` buffers;
    ``grid`` is (chunks x channel tiles, splits, clients); the partials of
    more than one split take ``scratch`` floats."""
    tile_imgs: int
    tile_rows: int
    tile_cols: int
    chunk: int
    bn: int
    stages: int
    splits: int
    ntiles: int
    smem_bytes: int
    scratch: int
    grid: tuple[int, int, int]


def dw_channel_stride(chunk: int, stride: int) -> int:
    """The weight gradient's window floats per pixel: a multiple of 4 whose
    product with the stride is 8 mod 16, where one exists (csrc
    dw_channel_stride), for conflict-free fragment reads of 4 pixels x 8
    channels."""
    c4 = _cdiv(chunk, 4) * 4
    return next((c for c in range(c4, c4 + 16, 4) if stride * c % 16 == 8),
                c4)


def dw_window_steps(kh: int, kw: int, stride: int) -> tuple[int, int]:
    """(input pixels between neighbouring window pixels, window pixels
    between neighbouring output pixels) of the weight gradient's window
    (csrc step, wstride): a 1x1 conv's window is just the input pixels its
    outputs read, strided over the input; a larger filter's is a box of the
    input."""
    return (stride, 1) if kh == kw == 1 else (1, stride)


def dw_row_stride(bn: int) -> int:
    """dy's floats per pixel in shared memory: 8 mod 16 (csrc DYP)."""
    return bn if bn % 16 == 8 else bn + 8


def conv_dw_plan(k: int, n: int, h: int, w: int, cin: int, cout: int,
                 kh: int, kw: int, stride: int, padding: str) -> DwPlan:
    """The weight-gradient kernel's plan for x (k, n, h, w, cin) and dy (k,
    n, oh, ow, cout), from the shapes alone; raises if none fits a block's
    shared memory."""
    oh, ow = _out_size(h, w, kh, kw, stride, padding)
    bn = min(_bn(cout), DW_MAX_BN)
    # a block's rows, kh*kw*chunk, fill as many of its 4 warps' m16 tiles
    # (a warp holds 16 / (bn / 8) of them) as Cin allows: a multiple of 4
    # channels where that fits, for 16-byte copies
    rows = 16 * 4 * (16 // (bn // 8))
    if kh * kw > rows:
        raise ValueError(f"grouped_conv dw kernel: a {kh}x{kw} filter has "
                         f"more taps than a block's {rows} rows")
    chunk = min(cin, rows // (kh * kw))
    if chunk < cin:
        chunk = chunk // 4 * 4 or chunk
    dyp = dw_row_stride(bn)
    _, ws = dw_window_steps(kh, kw, stride)

    def stage(imgs, rows_, cols, chunk):
        window = (imgs * ((rows_ - 1) * ws + kh) * ((cols - 1) * ws + kw)
                  * dw_channel_stride(chunk, ws))
        return 4 * (window + _cdiv(imgs * rows_ * cols, 8) * 8 * dyp)

    def two(imgs, rows_, cols):
        return table + 2 * stage(imgs, rows_, cols, chunk) <= DW_SMEM

    def small_or_two(imgs, rows_, cols):
        return imgs * rows_ * cols <= DW_MIN_PIXELS or two(imgs, rows_, cols)

    table = 4 * TILE_PIXELS
    imgs, trows, tcols = _pixel_tile(n, oh, ow)
    # fewer images a tile stage no more bytes a pixel (each image has a
    # window of its own), nor do fewer rows or columns of a 1x1 conv (no
    # halo): there the tile shrinks before the chunk does, to keep the
    # block's rows filled
    while imgs > 1 and not small_or_two(imgs, trows, tcols):
        imgs //= 2
    if kh * kw == 1:
        imgs, trows, tcols = _shrink_tile((imgs, trows, tcols), small_or_two)
    while not two(imgs, trows, tcols) and chunk > 4:
        chunk = max(4, chunk // 2 // 4 * 4)
    # Cin in as few chunks, as even as multiples of 4 allow: a short last
    # chunk would leave the others' blocks the grid's longest
    if chunk < cin and chunk % 4 == 0:
        chunk = min(chunk, _cdiv(_cdiv(cin, _cdiv(cin, chunk)), 4) * 4)
    imgs, trows, tcols = _shrink_tile(
        (imgs, trows, tcols),
        lambda i, r, c: table + stage(i, r, c, chunk) <= MAX_SMEM)
    one = stage(imgs, trows, tcols, chunk)
    if table + one > MAX_SMEM:
        raise ValueError(
            f"grouped_conv dw kernel: no tile plan fits {MAX_SMEM} bytes of "
            f"shared memory for a {kh}x{kw} stride-{stride} conv of width {w}")
    ntiles = _cdiv(n, imgs) * _cdiv(oh, trows) * _cdiv(ow, tcols)
    blocks = _cdiv(cin, chunk) * _cdiv(cout, bn) * k
    # the partials of every split at most twice x's bytes
    splits = max(1, min(_cdiv(DW_BLOCKS, blocks), ntiles // DW_MIN_TILES,
                        2 * n * h * w // (kh * kw * cout)))
    stages = 2 if ntiles // splits >= 2 and table + 2 * one <= MAX_SMEM else 1
    scratch = splits * k * kh * kw * cin * cout if splits > 1 else 0
    return DwPlan(imgs, trows, tcols, chunk, bn, stages, splits, ntiles,
                  table + stages * one, scratch,
                  (_cdiv(cin, chunk) * _cdiv(cout, bn), splits, k))


def _validate(x: torch.Tensor, w: torch.Tensor, padding: str) -> None:
    if x.ndim != 5 or w.ndim != 5:
        raise ValueError(
            f"client_batched_conv wants x (K, N, H, W, Cin) and w "
            f"(K, kh, kw, Cin, Cout); got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[0] != w.shape[0]:
        raise ValueError(f"client axes disagree: x has K={x.shape[0]}, w has "
                         f"K={w.shape[0]}")
    if x.shape[4] != w.shape[3]:
        raise ValueError(f"channels disagree: x has Cin={x.shape[4]}, w has "
                         f"Cin={w.shape[3]}")
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def grouped_conv_fwd(x: torch.Tensor, w: torch.Tensor, stride: int,
                     padding: str) -> torch.Tensor:
    """The forward: kernel on CUDA tensors, plain version on CPU tensors."""
    _validate(x, w, padding)
    if not x.is_cuda:
        return ref.grouped_conv_ref(x, w, stride, padding)
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"grouped_conv kernel takes float32, got {x.dtype} "
                        f"and {w.dtype}")
    x, w = x.contiguous(), w.contiguous()
    k, n, h, wd, cin = x.shape
    kh, kw, cout = w.shape[1], w.shape[2], w.shape[4]
    oh, lo_h, _ = ref.resolve_pads(h, kh, stride, padding)
    ow, lo_w, _ = ref.resolve_pads(wd, kw, stride, padding)
    if (k > 65535 or h * wd * cin >= 2 ** 31 or oh * ow * cout >= 2 ** 31
            or kh * kw * cin * cout >= 2 ** 31):
        raise ValueError(f"grouped_conv kernel: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} exceed its 32-bit index math "
                         f"inside an image or its 65535 clients")
    y = torch.empty((k, n, oh, ow, cout), device=x.device, dtype=x.dtype)
    if y.numel() == 0:
        return y
    plan = conv_plan(k, n, h, wd, cin, cout, kh, kw, stride, padding)
    if plan.grid[0] >= 2 ** 31 or plan.grid[1] >= 2 ** 16:
        raise ValueError(f"grouped_conv kernel: grid {plan.grid} too large "
                         f"for x {tuple(x.shape)}")
    rc = build.library().grouped_conv_fwd_f32(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), k, n, h, wd, cin, oh, ow,
        cout, kh, kw, stride, lo_h, lo_w, plan.tile_imgs, plan.tile_rows,
        plan.tile_cols, plan.chunk, plan.bn, plan.stages, plan.smem_bytes,
        build.stream_of(x))
    build.check(rc, "grouped_conv_fwd")
    LAUNCHES["grouped_conv_fwd"] += 1
    return y


def _grouped_conv_dw_cuda(x: torch.Tensor, dy: torch.Tensor, stride: int,
                          kh: int, kw: int, padding: str) -> torch.Tensor:
    if dy.device != x.device:
        raise ValueError(f"x on {x.device}, dy on {dy.device}")
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError(f"grouped_conv dw kernel takes float32, got "
                        f"{x.dtype} and {dy.dtype}")
    x, dy = x.contiguous(), dy.contiguous()
    k, n, h, wd, cin = x.shape
    oh, ow, cout = dy.shape[2], dy.shape[3], dy.shape[4]
    dw = torch.empty((k, kh, kw, cin, cout), device=x.device, dtype=x.dtype)
    if dw.numel() == 0:
        return dw
    if dy.numel() == 0:
        return dw.zero_()
    _, lo_h, _ = ref.resolve_pads(h, kh, stride, padding)
    _, lo_w, _ = ref.resolve_pads(wd, kw, stride, padding)
    if (k > 65535 or h * wd * cin >= 2 ** 31 or oh * ow * cout >= 2 ** 31
            or kh * kw * cin * cout >= 2 ** 31):
        raise ValueError(f"grouped_conv dw kernel: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} exceed its 32-bit index math "
                         f"inside an image or its 65535 clients")
    plan = conv_dw_plan(k, n, h, wd, cin, cout, kh, kw, stride, padding)
    if plan.grid[0] >= 2 ** 31:
        raise ValueError(f"grouped_conv dw kernel: grid {plan.grid} too large "
                         f"for x {tuple(x.shape)}")
    scratch = (torch.empty(plan.scratch, device=x.device, dtype=x.dtype)
               if plan.splits > 1 else None)
    rc = build.library().grouped_conv_dw_f32(
        x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
        None if scratch is None else scratch.data_ptr(), k, n, h, wd, cin,
        oh, ow, cout, kh, kw, stride, lo_h, lo_w, plan.tile_imgs,
        plan.tile_rows, plan.tile_cols, plan.chunk, plan.bn, plan.stages,
        plan.splits, plan.smem_bytes, build.stream_of(x))
    build.check(rc, "grouped_conv_dw")
    LAUNCHES["grouped_conv_dw"] += 1
    return dw


def _dw_cost(x, dy, stride, kh, kw, padding, out=None) -> roofline.Cost:
    k, n, h, wd, cin = x.shape
    cout = dy.shape[4]
    cost = roofline.grouped_conv_dw_cost(k, n, h, wd, cin, cout, kh, kw,
                                         stride, padding)
    if x.numel() == 0 or dy.numel() == 0:
        return cost
    plan = conv_dw_plan(k, n, h, wd, cin, cout, kh, kw, stride, padding)
    return cost._replace(scratch=4.0 * plan.scratch)


_GROUPED_CONV_DW = define_op(
    "grouped_conv_dw", "(Tensor x, Tensor dy, int stride, int kh, int kw, "
    "str padding) -> Tensor",
    cpu=ref.shift_gemm_dw, cuda=_grouped_conv_dw_cuda,
    fake=lambda x, dy, stride, kh, kw, padding: x.new_empty(
        (x.shape[0], kh, kw, x.shape[4], dy.shape[4])),
    cost=_dw_cost)


def grouped_conv_dw(x: torch.Tensor, dy: torch.Tensor, stride: int, kh: int,
                    kw: int, padding: str = "SAME") -> torch.Tensor:
    """The filters' gradient (K, kh, kw, Cin, Cout) of the conv of x (K,
    N, H, W, Cin) whose output gradient is dy (K, N, OH, OW, Cout): one
    ``repro_torch::grouped_conv_dw`` (the kernel on CUDA tensors,
    ``ref.shift_gemm_dw`` on CPU tensors)."""
    if x.ndim != 5 or dy.ndim != 5 or x.shape[:2] != dy.shape[:2]:
        raise ValueError(f"grouped_conv_dw wants x (K, N, H, W, Cin) and dy "
                         f"(K, N, OH, OW, Cout); got {tuple(x.shape)} and "
                         f"{tuple(dy.shape)}")
    oh = ref.resolve_pads(x.shape[2], kh, stride, padding)[0]
    ow = ref.resolve_pads(x.shape[3], kw, stride, padding)[0]
    if (dy.shape[2], dy.shape[3]) != (oh, ow):
        raise ValueError(f"dy's {tuple(dy.shape[2:4])} pixels are not the "
                         f"{(oh, ow)} a {kh}x{kw} stride-{stride} {padding} "
                         f"conv of {tuple(x.shape[2:4])} gives")
    return _GROUPED_CONV_DW(x, dy, int(stride), int(kh), int(kw), padding)


class _ConvDw(torch.autograd.Function):
    """The weight gradient as a Function of its own, so that the conv's
    backward is made of Functions with vmap rules and runs under
    ``torch.func.vmap`` of ``grad`` as one launch (a kernel has no batched
    form of its pointers).  No path differentiates it again."""

    @staticmethod
    def forward(x, dy, stride: int, kh: int, kw: int, padding: str):
        return grouped_conv_dw(x, dy, stride, kh, kw, padding)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("grouped_conv_dw has no derivative of its own: "
                           "the conv's second derivative is not supported")

    @staticmethod
    def vmap(info, in_dims, x, dy, stride, kh, kw, padding):
        """Fold the vmapped axis into the client axis, as the conv's rule
        does: (B, K, ...) -> (B·K, ...), one launch."""
        b = info.batch_size
        dw = _ConvDw.apply(*_fold_clients(b, in_dims[:2], (x, dy)), stride,
                           kh, kw, padding)
        return dw.reshape((b, -1) + tuple(dw.shape[1:])), 0


def _fold_clients(b: int, in_dims, tensors) -> list[torch.Tensor]:
    """Each tensor with its vmapped axis moved to the front (broadcast
    there where it is not vmapped) and folded into the client axis."""
    folded = []
    for t, d in zip(tensors, in_dims):
        t = t.expand((b,) + tuple(t.shape)) if d is None else t.movedim(d, 0)
        folded.append(t.reshape((-1,) + tuple(t.shape[2:])))
    return folded


class _ClientBatchedConv(torch.autograd.Function):
    @staticmethod
    def forward(x, w, stride: int, padding: str):
        return grouped_conv_fwd(x, w, stride, padding)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, stride, padding = inputs
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding

    @staticmethod
    def backward(ctx, dy):
        # dx in plain PyTorch and dw through a Function with a vmap rule,
        # so the backward runs under torch.func.vmap; the named ranges let
        # a profile total each gradient's device time
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            with trace.span("grouped_conv_dx"):
                dx = ref.grouped_conv_dx(dy, w, ctx.stride, x.shape[2],
                                         x.shape[3], ctx.padding)
        if ctx.needs_input_grad[1]:
            with trace.span("grouped_conv_dw"):
                dw = _ConvDw.apply(x, dy, ctx.stride, w.shape[1], w.shape[2],
                                   ctx.padding)
        return dx, dw, None, None

    @staticmethod
    def vmap(info, in_dims, x, w, stride, padding):
        """Fold the vmapped axis B into the client axis: (B, K, ...) ->
        (B·K, ...), one launch for every client of every vmapped slice
        (an argument that is not vmapped is broadcast over B first)."""
        b = info.batch_size
        y = _ClientBatchedConv.apply(*_fold_clients(b, in_dims[:2], (x, w)),
                                     stride, padding)
        return y.reshape((b, -1) + tuple(y.shape[1:])), 0


def client_batched_conv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                        padding: str = "SAME") -> torch.Tensor:
    """Per-client convolution over a stacked cohort, one kernel launch."""
    return _ClientBatchedConv.apply(x, w, int(stride), padding)
