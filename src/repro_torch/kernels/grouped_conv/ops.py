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
Backward: ``ref.grouped_conv_dx`` and ``ref.shift_gemm_dw``, per-tap
K-batched matmuls on either device, as the reference's custom VJP computes
them outside Pallas.

Under ``torch.func.vmap`` (the executor's vmapped round body, the vmapped
client hooks) the Function's vmap rule folds the vmapped axis into K: a
vmapped single-client conv, K=1, becomes one launch over every vmapped
client.  The backward is plain PyTorch and is vmapped as it stands.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import trace
from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.grouped_conv import ref


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


def conv_plan(k: int, n: int, h: int, w: int, cin: int, cout: int, kh: int,
              kw: int, stride: int, padding: str) -> ConvPlan:
    """The kernel's tiles for x (k, n, h, w, cin) and w (k, kh, kw, cin,
    cout); raises if no plan fits a block's shared memory."""
    oh = ref.resolve_pads(h, kh, stride, padding)[0]
    ow = ref.resolve_pads(w, kw, stride, padding)[0]
    if oh < 1 or ow < 1:
        raise ValueError(f"grouped_conv kernel: a {kh}x{kw} {padding} conv "
                         f"of {h}x{w} has no output")
    cols = min(ow, TILE_PIXELS)
    rows = min(oh, TILE_PIXELS // cols)
    imgs = (min(n, TILE_PIXELS // (rows * cols))
            if rows == oh and cols == ow else 1)
    bn = next((b for b in (8, 16, 32) if cout <= b), 64)
    chunk = min(cin, MAX_CHUNK)

    def stage():
        return 4 * _stage_floats(imgs, rows, cols, chunk, bn, kh, kw, stride)

    def table():
        return 4 * _cdiv(kh * kw * chunk, 8) * 8

    while stage() > STAGE_BYTES and chunk > 4:
        chunk = _cdiv(chunk, 2)
    # the pixel tile shrinks only where one stage would not fit at all
    # (wide rows, large filters)
    while table() + stage() > MAX_SMEM and imgs > 1:
        imgs //= 2
    while table() + stage() > MAX_SMEM and rows > 1:
        rows = _cdiv(rows, 2)
    while table() + stage() > MAX_SMEM and cols > 8:
        cols = _cdiv(cols, 2)
    stages = 2 if cin > chunk and table() + 2 * stage() <= MAX_SMEM else 1
    smem = table() + stages * stage()
    if smem > MAX_SMEM:
        raise ValueError(
            f"grouped_conv kernel: no tile plan fits {MAX_SMEM} bytes of "
            f"shared memory for a {kh}x{kw} stride-{stride} conv of width {w}")
    grid = (_cdiv(n, imgs) * _cdiv(oh, rows) * _cdiv(ow, cols),
            _cdiv(cout, bn), k)
    return ConvPlan(imgs, rows, cols, chunk, bn, stages, smem, grid)


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
        # plain PyTorch ops only, so the backward runs under torch.func.vmap;
        # the named ranges let a profile total each gradient's device time
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            with trace.span("grouped_conv_dx"):
                dx = ref.grouped_conv_dx(dy, w, ctx.stride, x.shape[2],
                                         x.shape[3], ctx.padding)
        if ctx.needs_input_grad[1]:
            with trace.span("grouped_conv_dw"):
                dw = ref.shift_gemm_dw(x, dy, ctx.stride, w.shape[1],
                                       w.shape[2], ctx.padding)
        return dx, dw, None, None

    @staticmethod
    def vmap(info, in_dims, x, w, stride, padding):
        """Fold the vmapped axis B into the client axis: (B, K, ...) ->
        (B·K, ...), one launch for every client of every vmapped slice
        (an argument that is not vmapped is broadcast over B first)."""
        b = info.batch_size
        folded = []
        for t, d in zip((x, w), in_dims[:2]):
            t = (t.expand((b,) + tuple(t.shape)) if d is None
                 else t.movedim(d, 0))
            folded.append(t.reshape((-1,) + tuple(t.shape[2:])))
        y = _ClientBatchedConv.apply(*folded, stride, padding)
        return y.reshape((b, -1) + tuple(y.shape[1:])), 0


def client_batched_conv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                        padding: str = "SAME") -> torch.Tensor:
    """Per-client convolution over a stacked cohort, one kernel launch."""
    return _ClientBatchedConv.apply(x, w, int(stride), padding)
