"""Flash attention: the CUDA forward kernel with an autograd rule.

``flash_attention_gqa(q, k, v, causal=True, window=None)`` takes the
reference's layout, q (B, Sq, Hq, D) and k/v (B, Skv, Hkv, D) with Hq a
multiple of Hkv, and returns (B, Sq, Hq, D).  A ``window`` takes effect
with ``causal`` only, as in the reference's ``attention_ref``.

Forward: ``flash_attention_fwd`` is one operator of the ``repro_torch``
library (``kernels.define_op``).  On a CUDA tensor it launches a kernel
(built at first use; a failed launch raises) and counts the launch; on a
CPU tensor it takes ``ref.attention_ref``; on a meta tensor it gives o's
shape only, counted by ``launch.roofline.flash_cost``.  Nothing falls back
from one to another.  fp32 inputs take the fp32 form, ``csrc/flash_attention.cu``
(3xTF32 ``mma.sync``; ``flash_attention_fwd``'s count), bf16 inputs the
bf16 form, ``csrc/flash_attention_bf16.cu`` (bf16 ``wgmma`` on bf16
tiles that a copying warp brings in by TMA; fp32 softmax and P, P·V as
P's two bf16 halves against V, o rounded once to bf16;
``flash_attention_fwd_bf16``'s count); any other type raises.  Each form
has its own launch plan (``launch_plan``); the bf16 form's entry point
takes its shared bytes and refuses a plan it was not compiled for.  The
kernels read the inputs through their strides.  The fp32 form copies
nothing unless the last axis is strided; the bf16 form copies where TMA
cannot address the layout (``_tma_ready``: head_dim or a stride not a
multiple of 8 values, data not 16-byte aligned), into contiguous tensors
with head_dim padded by zeros to a multiple of 8, and slices the output
back.  No path of the port gives it such a layout.

Backward: attention recomputed with PyTorch matmuls in fp32 on either
device (``attention_bwd``; the gradients cast to the inputs' dtypes), as
the reference's custom VJP recomputes through the plain attention outside
Pallas: P from q and k, dV = Pᵀ·dO,
dP = dO·Vᵀ, dS = P∘(dP − rowsum(dO∘O)), dQ = scale·dS·K, dK = scale·dSᵀ·Q,
with dK and dV summed over each GQA group.  A backward kernel is later
work.

One difference from the plain version, on no shape the port runs: a
query row that sees no key (causal with a window, Sq > Skv + window − 1)
gets 0 from the kernel, as from the TPU kernel, and the mean of v from the
plain version's finite mask value.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, build, define_op
from repro_torch.kernels.flash_attention import ref
from repro_torch.launch import roofline

MAX_HEAD_DIM = 128
BLOCK_Q = 64            # query rows per thread block (csrc kBlockQ)
BLOCK_KV = 64           # keys per staged tile (csrc kBlockKV), both forms
THREADS = 128           # 4 warps of 16 query rows
STAGES_BF16 = 3         # the bf16 form's stages of k and v (csrc kStages)
MAX_SMEM = 232_448      # the shared memory one block may take on sm_90
# input type -> (C entry point, launch counter)
_FORMS = {torch.float32: ("flash_attention_fwd_f32", "flash_attention_fwd"),
          torch.bfloat16: ("flash_attention_fwd_bf16",
                           "flash_attention_fwd_bf16")}


def launch_plan(b: int, sq: int, hq: int, d: int,
                dtype: torch.dtype = torch.float32):
    """(grid, threads, shared-memory bytes) of the launch of the form for
    ``dtype``.  fp32: a block per (batch * query head, 64 query rows) of
    4 warps; the q tile and two stages of k and v tiles in fp32, head_dim
    padded to a multiple of 32 and each row by 4 floats (csrc smem_bytes
    of flash_attention.cu).  bf16: a block per (batch * query head, 64
    query rows a warpgroup) of a copying warp and two warpgroups, three at
    head_dim <= 64; the q tile and three stages of k and v tiles in bf16,
    head_dim padded to 64 or 128 (one or two 64-column atoms of 128-byte
    rows), plus 1,024 bytes to align the tiles to the swizzle's period
    (csrc smem_bytes of flash_attention_bf16.cu, which refuses any other
    count)."""
    if dtype == torch.bfloat16:
        atoms = 1 if d <= 64 else 2
        consumers = 3 if atoms == 1 else 2
        rows = 64 * consumers
        smem = 1024 + (rows + STAGES_BF16 * 2 * BLOCK_KV) * 128 * atoms
        return (b * hq, -(-sq // rows)), 128 * consumers + 32, smem
    dp = 32 * -(-d // 32)
    smem = 4 * (BLOCK_Q + 4 * BLOCK_KV) * (dp + 4)
    return (b * hq, -(-sq // BLOCK_Q)), THREADS, smem


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether the bf16 form's TMA copies take ``t`` as it is: head_dim
    and every stride of an axis longer than 1 a multiple of 8 values (16
    bytes), the last axis contiguous, the data 16-byte aligned."""
    return (t.shape[-1] % 8 == 0 and t.stride(-1) == 1
            and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3])
                    if n > 1))


def _validate(q, k, v, window) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention wants q (B, Sq, Hq, D) and k, v "
                         f"(B, Skv, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         f"on batch or head_dim, or Hq is not a multiple of Hkv")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _flash_cpu(q, k, v, causal: bool, window: Optional[int]):
    # contiguous, as the kernel writes o (the plain version's einsum may
    # leave it permuted)
    return ref.attention_ref(q, k, v, causal=causal,
                             window=window).contiguous()


def _flash_cuda(q, k, v, causal: bool, window: Optional[int]):
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dtype not in _FORMS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash attention kernel takes float32 or "
                        f"bfloat16 q, k and v of one type, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    entry, counter = _FORMS[q.dtype]
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM}: the kernel keeps "
                         f"16 rows of the output in one warp's registers")
    grid, _, smem = launch_plan(b, sq, hq, d, q.dtype)
    if grid[1] >= 2 ** 16 or grid[0] >= 2 ** 31:
        raise ValueError(f"grid too large for q {tuple(q.shape)}")
    scale = 1.0 / math.sqrt(d)
    plan, dk = (), d
    if q.dtype == torch.bfloat16:
        plan = (smem,)
        if not all(map(_tma_ready, (q, k, v))):
            # a layout TMA cannot address: contiguous copies, head_dim
            # padded with zeros to a multiple of 8
            dk = d + -d % 8
            q, k, v = (torch.nn.functional.pad(t, (0, dk - d)).contiguous()
                       for t in (q, k, v))
    else:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
    o = torch.empty((b, sq, hq, dk), device=q.device, dtype=q.dtype)
    rc = getattr(build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, sq, skv, hq, hkv, dk, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *o.stride()[:3], int(causal),
        int(window) if (causal and window is not None) else 0,
        scale, *plan, build.stream_of(q))
    build.check(rc, counter)
    LAUNCHES[counter] += 1
    return o if dk == d else o[..., :d].contiguous()


def _flash_cost(q, k, v, causal: bool, window: Optional[int], out=None):
    b, sq, hq, d = q.shape
    return roofline.flash_cost(b, sq, k.shape[1], hq, k.shape[2], d, causal,
                               window if causal else None,
                               q.element_size())


_FLASH_FWD = define_op(
    "flash_attention_fwd", "(Tensor q, Tensor k, Tensor v, bool causal, "
    "int? window) -> Tensor",
    cpu=_flash_cpu, cuda=_flash_cuda,
    fake=lambda q, k, v, causal, window: torch.empty_like(
        q, memory_format=torch.contiguous_format),
    cost=_flash_cost)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """The forward, one ``repro_torch::flash_attention_fwd``: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    _validate(q, k, v, window)
    return _FLASH_FWD(q, k, v, bool(causal),
                      None if window is None else int(window))


def attention_bwd(q, k, v, o, do, causal: bool, window: Optional[int]):
    """(dq, dk, dv) of the attention ``o`` at output gradient ``do``,
    recomputing P in fp32 with the plain version's mask."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    mask = (ref.causal_mask(sq, skv, window=window, device=q.device)
            if causal else None)
    p = ref.attention_probs(q, k, mask, scale)             # (b, hkv, g, q, k)
    qg = q.to(torch.float32).reshape(b, sq, hkv, g, d)
    dog = do.to(torch.float32).reshape(b, sq, hkv, g, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.to(torch.float32))
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
    delta = delta.reshape(b, sq, hkv, g).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        o = flash_attention_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, do, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Attention over grouped-query heads, one kernel launch forward."""
    return _FlashAttention.apply(q, k, v, bool(causal), window)
