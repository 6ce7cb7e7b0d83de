"""Mamba-2 SSD scan: the CUDA forward kernels with an autograd rule.

``ssd_scan(x, dt, A, B, C, *, chunk, init_state=None)`` has the contract
of the reference's ``repro.kernels.ssd_scan.ops.ssd_scan`` and of
``ref.ssd_chunked``: x (B, L, H, P), dt (B, L, H) (softplus'ed), A (H,)
negative, B and C (B, L, G, N) with G dividing H, and the state entering
the first chunk, ``init_state`` (B, H, P, N), or zero; it returns
(y (B, L, H, P) in x's dtype, final state (B, H, P, N) fp32).  As the
reference's wrapper does, it casts its inputs to fp32 around the kernels
(fp32 or bf16 x); the kernels themselves take fp32 only, and their
launches count as ``ssd_scan_fwd`` whatever x's dtype.

Forward: ``ssd_scan_fwd`` is one operator of the ``repro_torch`` library
(``kernels.define_op``).  On a CUDA tensor it launches the kernels of
``csrc/ssd_scan.cu`` (``ssd_scan_launch``; built at first use; a failed
launch raises) and counts one launch per call; on a CPU tensor it takes
``ref.ssd_scan_ref``; on a meta tensor it gives the outputs' shapes only,
counted by ``launch.roofline.ssd_cost`` with the plan's scratch.  Nothing
falls back from one to another.  The kernels split the scan as
the SSD algorithm does: the chunk states and C·Bᵀ (once per B/C group) in
parallel over chunks, a pass over the chunks for the state entering each
(starting from ``init_state`` where one is given), then every chunk's
output in parallel.  They read the inputs through their strides (no
repeat of B/C per head, no transposes, no padded copy of a ragged
length).  Their plan (``ssd_plan``: scratch shapes, grids, shared
memory, whether rows are staged with 16-byte copies) is made here, where
the CPU tests reach it, and the C entry point recounts it and refuses a
plan that disagrees.

Backward: ``ref.ssd_chunked`` recomputed under autograd, and its
vector-Jacobian product for (x, dt, A, B, C) and ``init_state``, on
either device: the reference's own VJP (``jax.vjp`` of ``ssd_chunked``).
A backward kernel is later work.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch import trace
from repro_torch.kernels import LAUNCHES, build, define_op
from repro_torch.kernels.ssd_scan import ref
from repro_torch.launch import roofline

MAX_HEAD_DIM = 128      # P (csrc kMaxP)
MAX_STATE = 256         # N (csrc kMaxN)
MAX_CHUNK = 256         # Q (csrc kMaxChunk)
TILE = 64               # rows of an output or C·Bᵀ tile (csrc kTile)
STATE_TILE = 64         # p and n of a chunk-state block (csrc kTileS)
PASS_ELEMS = 1024       # state elements of a state-pass block (csrc
                        # kPassThreads x kPassPer)
MAX_SMEM = 232_448      # the shared memory one block may take on sm_90
_SCAN_BYTES = MAX_CHUNK * (8 + 4)      # fp64 prefix sums and dt of a chunk


@dataclasses.dataclass(frozen=True)
class SSDPlan:
    """How ``csrc/ssd_scan.cu`` runs one call.  ``chunks`` = ceil(L / Q)
    chunks of ``row_tiles`` 64-row tiles each; the head dim is padded to 32
    x ``pc``.  Scratch: ``states_shape`` (the chunk states, then the state
    entering each chunk), ``cb_shape`` (C·Bᵀ per group as ``row_tiles``
    (``row_tiles`` + 1) / 2 tiles of 64 x 64) and ``decay_shape`` (each
    chunk's total decay).  ``grid``: the blocks of the chunk kernel (chunk
    states, then C·Bᵀ tiles), of the state pass and of the output kernel;
    ``chunk_smem`` and ``out_smem`` are the tiled kernels' shared bytes."""
    chunks: int
    row_tiles: int
    pc: int
    vec_x: bool
    vec_bc: bool
    chunk_smem: int
    out_smem: int
    states_shape: tuple[int, int, int, int, int]
    cb_shape: tuple[int, int, int, int, int]
    decay_shape: tuple[int, int, int]
    grid: tuple[int, int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chunk_smem_bytes() -> int:
    """The chunk kernel's shared bytes (csrc chunk_smem_bytes): two stages
    of x and B rows [32][72] for a chunk state, or of C and B [64][36] for
    C·Bᵀ (the same 9,216 floats)."""
    return _SCAN_BYTES + 4 * max(2 * 2 * 32 * (STATE_TILE + 8),
                                 2 * 2 * TILE * 36)


def out_smem_bytes(pc: int) -> int:
    """The output kernel's shared bytes at head dim 32 x ``pc`` (csrc
    out_smem_bytes): two stages of C [64][36] and S_in [32 pc][36], or, in
    the same space, of x [64][32 pc + 4]."""
    return _SCAN_BYTES + 4 * max(2 * (TILE + 32 * pc) * 36,
                                 2 * TILE * (32 * pc + 4))


def copy16(ptr: int, strides: tuple[int, ...], width: int) -> bool:
    """Whether rows of ``width`` floats of an operand at address ``ptr``
    with element ``strides`` (last: along the row) may be staged with
    16-byte copies: unit element stride, the width and every other stride
    a multiple of 4 floats, and the base 16-byte aligned.  The path's x, B
    and C, slices of one (B, L, H·P + 2·G·N) tensor at offsets 0, H·P and
    H·P + G·N, pass where those are multiples of 4."""
    *outer, elem = strides
    return (elem == 1 and width % 4 == 0 and all(s % 4 == 0 for s in outer)
            and ptr % 16 == 0)


def ssd_plan(b: int, l: int, h: int, p: int, g: int, n: int, chunk: int,
             vec_x: bool = False, vec_bc: bool = False) -> SSDPlan:
    """The kernels' plan for x (b, l, h, p) and B/C (b, l, g, n) at
    ``chunk``; raises where the kernels do not reach."""
    if not (1 <= p <= MAX_HEAD_DIM and 1 <= n <= MAX_STATE
            and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"ssd_scan kernel takes P <= {MAX_HEAD_DIM}, N <= "
                         f"{MAX_STATE}, 1 <= chunk <= {MAX_CHUNK}; got P={p}, "
                         f"N={n}, chunk={chunk}")
    if g < 1 or h % g != 0:
        raise ValueError(f"ssd_scan: {g} groups do not divide {h} heads")
    nc, nt, pc = _cdiv(l, chunk), _cdiv(chunk, TILE), _cdiv(p, 32)
    tri = nt * (nt + 1) // 2
    state_blocks = (b * nc * h * _cdiv(p, STATE_TILE)
                    * _cdiv(n, STATE_TILE))
    grid = (state_blocks + b * nc * g * tri,
            b * h * _cdiv(p * n, PASS_ELEMS), b * nc * nt * h)
    if max(grid) >= 2 ** 31:
        raise ValueError(f"ssd_scan kernel: grid {grid} too large for "
                         f"(B, L, H) = ({b}, {l}, {h})")
    return SSDPlan(nc, nt, pc, vec_x, vec_bc, chunk_smem_bytes(),
                   out_smem_bytes(pc), (b, nc, h, p, n),
                   (b, nc, g, tri, TILE * TILE), (b, nc, h), grid)


def _validate(x, dt, A, B, C, init_state=None) -> None:
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or B.ndim != 4 or B.shape != C.shape:
        raise ValueError(
            f"ssd_scan wants x (B, L, H, P), dt (B, L, H), A (H,), B and C "
            f"(B, L, G, N); got {[tuple(t.shape) for t in (x, dt, A, B, C)]}")
    b, l, h, _ = x.shape
    if (tuple(dt.shape) != (b, l, h) or tuple(A.shape) != (h,)
            or tuple(B.shape[:2]) != (b, l) or h % B.shape[2] != 0):
        raise ValueError(
            f"ssd_scan: shapes disagree or G does not divide H: "
            f"{[tuple(t.shape) for t in (x, dt, A, B, C)]}")
    want = (b, h, x.shape[3], B.shape[3])
    if init_state is not None and tuple(init_state.shape) != want:
        raise ValueError(f"ssd_scan: init_state {tuple(init_state.shape)}, "
                         f"want (B, H, P, N) = {want}")


def ssd_scan_launch(x, dt, A, B, C, chunk: int, init_state=None):
    """Launch the kernels on CUDA tensors: (y, final state, and the scratch
    that holds, after the call, the state entering each chunk (B, nc, H, P,
    N)).  The first chunk's entering state is ``init_state`` (B, H, P, N),
    or zero.  Raises on a CPU tensor, a type or range the kernels do not
    take, or a failed launch."""
    _validate(x, dt, A, B, C, init_state)
    ins = (x, dt, A, B, C) + (() if init_state is None else (init_state,))
    if not x.is_cuda:
        raise ValueError("ssd_scan_launch runs the CUDA kernels: the inputs "
                         "are on the CPU")
    if any(t.device != x.device for t in ins):
        raise ValueError(f"ssd_scan inputs on several devices, x on {x.device}")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"the ssd_scan kernel takes float32, got "
                        f"{[t.dtype for t in ins]}")
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    plan = ssd_plan(b, l, h, p, g, n, chunk,
                    vec_x=copy16(x.data_ptr(), x.stride(), p),
                    vec_bc=(copy16(B.data_ptr(), B.stride(), n)
                            and copy16(C.data_ptr(), C.stride(), n)))
    f32 = dict(device=x.device, dtype=torch.float32)
    y = torch.empty((b, l, h, p), **f32)
    state = torch.empty((b, h, p, n), **f32)
    states = torch.empty(plan.states_shape, **f32)
    cb = torch.empty(plan.cb_shape, **f32)
    decay = torch.empty(plan.decay_shape, **f32)
    lib = build.library()
    if init_state is None:
        entry = lib.ssd_scan_fwd_f32
    else:
        init_state = init_state.contiguous()
        entry = functools.partial(lib.ssd_scan_fwd_init_f32,
                                  init_state.data_ptr())
    rc = entry(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), states.data_ptr(), cb.data_ptr(),
        decay.data_ptr(), b, l, h, p, g, n, chunk,
        *x.stride(), *dt.stride(), A.stride(0), *B.stride(), *C.stride(),
        int(plan.vec_x), int(plan.vec_bc), plan.chunk_smem, plan.out_smem,
        build.stream_of(x))
    build.check(rc, "ssd_scan_fwd")
    LAUNCHES["ssd_scan_fwd"] += 1
    return y, state, states


def _ssd_cpu(x, dt, A, B, C, chunk: int, init_state=None):
    return ref.ssd_scan_ref(x, dt, A, B, C, chunk, init_state)


def _ssd_cuda(x, dt, A, B, C, chunk: int, init_state=None):
    y, state, _ = ssd_scan_launch(x, dt, A, B, C, chunk, init_state)
    return y, state


def _ssd_fake(x, dt, A, B, C, chunk: int, init_state=None):
    b, l, h, p = x.shape
    return (x.new_empty((b, l, h, p), dtype=torch.float32),
            x.new_empty((b, h, p, B.shape[3]), dtype=torch.float32))


def _ssd_cost(x, dt, A, B, C, chunk: int, init_state=None, out=None):
    """``roofline.ssd_cost``, with the scratch the launch allocates for its
    duration (the plan's chunk states, C·Bᵀ tiles and decays)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    plan = ssd_plan(b, l, h, p, g, n, chunk)
    scratch = 4 * sum(math.prod(s) for s in (plan.states_shape,
                                              plan.cb_shape,
                                              plan.decay_shape))
    return roofline.ssd_cost(b, l, h, p, g, n, chunk,
                             init_state=init_state is not None)._replace(
        scratch=scratch)


_SSD_FWD = define_op(
    "ssd_scan_fwd", "(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, "
    "int chunk, Tensor? init_state=None) -> (Tensor, Tensor)",
    cpu=_ssd_cpu, cuda=_ssd_cuda, fake=_ssd_fake, cost=_ssd_cost)


def ssd_scan_fwd(x, dt, A, B, C, chunk: int, init_state=None):
    """The forward, one ``repro_torch::ssd_scan_fwd``: the kernels on CUDA
    tensors (``ssd_scan_launch``), the plain version on CPU tensors."""
    _validate(x, dt, A, B, C, init_state)
    return _SSD_FWD(x, dt, A, B, C, int(chunk), init_state)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, init_state, chunk: int):
        y, state = ssd_scan_fwd(x, dt, A, B, C, chunk, init_state)
        ctx.save_for_backward(x, dt, A, B, C, init_state)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        saved = ctx.saved_tensors          # unpacked once (checkpointing)
        live = [t for t in saved if t is not None]
        inputs = [t.detach().to(torch.float32).requires_grad_(True)
                  for t in live]
        # named for the profiler: its device time is the backward's cost
        with torch.enable_grad(), trace.span("ssd_scan_backward"):
            y, state = ref.ssd_chunked(
                *inputs[:5], chunk=ctx.chunk,
                init_state=inputs[5] if len(inputs) == 6 else None)
            grads = torch.autograd.grad((y, state), inputs, (gy, gstate))
        grads = [g.to(t.dtype) for g, t in zip(grads, live)]
        return (*grads, *([None] * (6 - len(grads))), None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None):
    """SSD scan, one counted launch forward: (y in x's dtype, final state
    fp32), every input cast to fp32 around the kernels."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_scan takes a float32 or bfloat16 x, got "
                        f"{x.dtype}")
    f32 = lambda t: None if t is None else t.to(torch.float32)
    y, state = _SSDScan.apply(f32(x), f32(dt), f32(A), f32(B), f32(C),
                              f32(init_state), int(chunk))
    return y.to(x.dtype), state
