"""Fused KD-KL loss: the CUDA kernels with an autograd rule.

``kd_kl_loss(teacher_logits, student_logits, temperature)`` takes any
``(..., V)`` shapes and returns the per-row KL(p_T‖p_S)·temp² with the
leading dims kept.  Gradients flow to the student only (the FedGKD teacher
is a frozen ensemble, Eq. 4): the backward returns no teacher gradient.

``row_logsumexp(logits, temperature=1.0)`` maps (T, V) to the (T,) fp32
logsumexp(l / T), for every T and V (the reference's Pallas kernel covers
whole blocks only); its backward is elementwise PyTorch,
g·softmax(l / T) / T.

Each launch function (``kd_kl_fwd``, ``kd_kl_bwd``, ``row_lse_fwd``) is
one operator of the ``repro_torch`` library (``kernels.define_op``): on a
CUDA tensor it launches the kernels of ``csrc/kd_kl.cu`` (built at first
use) and raises if a launch fails; on a CPU tensor it takes the plain
versions in ``ref.py``; on a meta tensor it gives the outputs' shapes
only, counted by ``launch.roofline``'s cost functions.  Nothing falls back
from one to another.
The kernels read fp32 or bf16 logits (their bf16 forms count under
``*_bf16``) and compute in fp32, as the reference's Pallas kernels do: kl
and the logsumexps are fp32, B2's ``dls`` is written in the student's
type.  A teacher and a student of two types meet in fp32 (the bf16 one
cast up, which is exact).  Any other type raises.

Under ``torch.func`` (``grad``, ``vmap`` and their compositions, as the
executor's vmapped round body runs them) the Functions' vmap rules fold
the vmapped axis into the row axis — B1, B2 and B6 are row-wise, so that
is exact — and launch the same kernels once over all rows; B1's backward
runs B2 through a Function of its own for the same reason.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build, define_op
from repro_torch.kernels.kd_kl import ref
from repro_torch.launch import roofline


# logits type -> the C entry points' suffix and the counters' suffix
_FORMS = {torch.float32: ("f32", ""), torch.bfloat16: ("bf16", "_bf16")}


def _check(t: torch.Tensor, what: str, types=(torch.float32,)) -> torch.Tensor:
    if t.dtype not in types:
        raise TypeError(f"kd_kl kernels take {what} in "
                        f"{[str(d) for d in types]}, got {t.dtype}")
    return t.contiguous()


def _logits(lt: torch.Tensor, ls: torch.Tensor):
    """Teacher and student logits of one type the kernels read, with the
    entry points' and counters' suffixes."""
    lt = _check(lt, "teacher logits", tuple(_FORMS))
    ls = _check(ls, "student logits", tuple(_FORMS))
    if lt.dtype != ls.dtype:
        lt, ls = lt.to(torch.float32), ls.to(torch.float32)
    return lt, ls, _FORMS[lt.dtype]


def _kd_kl_fwd_cuda(lt: torch.Tensor, ls: torch.Tensor, temperature: float):
    if ls.device != lt.device:
        raise ValueError(f"teacher on {lt.device}, student on {ls.device}")
    lt, ls, (entry, counter) = _logits(lt, ls)
    rows, vocab = lt.shape
    kl, lse_t, lse_s = (torch.empty(rows, device=lt.device) for _ in range(3))
    rc = getattr(build.library(), "kd_kl_fwd_" + entry)(
        lt.data_ptr(), ls.data_ptr(), kl.data_ptr(), lse_t.data_ptr(),
        lse_s.data_ptr(), rows, vocab, 1.0 / temperature,
        temperature * temperature, build.stream_of(lt))
    build.check(rc, "kd_kl_fwd" + counter)
    LAUNCHES["kd_kl_fwd" + counter] += 1
    return kl, lse_t, lse_s


def _elt(*ts: torch.Tensor) -> int:
    """Bytes an element of the logits the kernels read: 2 where every
    tensor is bf16, else 4 (two types meet in fp32)."""
    return 2 if all(t.dtype == torch.bfloat16 for t in ts) else 4


_KD_KL_FWD = define_op(
    "kd_kl_fwd", "(Tensor lt, Tensor ls, float temperature) -> "
    "(Tensor, Tensor, Tensor)",
    cpu=ref.kd_kl_fwd_ref, cuda=_kd_kl_fwd_cuda,
    fake=lambda lt, ls, temperature: tuple(
        lt.new_empty(lt.shape[:1], dtype=torch.float32) for _ in range(3)),
    cost=lambda lt, ls, temperature, out=None: roofline.kd_kl_fwd_cost(
        *lt.shape, _elt(lt, ls)))


def kd_kl_fwd(lt: torch.Tensor, ls: torch.Tensor, temperature: float):
    """(T, V) x (T, V), fp32 or bf16 -> (kl (T,), lse_t (T,), lse_s
    (T,)), fp32: one ``repro_torch::kd_kl_fwd``."""
    if lt.shape != ls.shape or lt.ndim != 2:
        raise ValueError(f"kd_kl_fwd wants two (T, V) tensors, got "
                         f"{tuple(lt.shape)} and {tuple(ls.shape)}")
    return _KD_KL_FWD(lt, ls, float(temperature))


def _kd_kl_bwd_cpu(lt, ls, lse_t, lse_s, g, temperature: float):
    return ref.kd_kl_bwd_ref(lt, ls, lse_t, lse_s, g,
                             temperature).to(ls.dtype)


def _kd_kl_bwd_cuda(lt, ls, lse_t, lse_s, g, temperature: float):
    if any(t.device != lt.device for t in (ls, lse_t, lse_s, g)):
        raise ValueError(f"kd_kl_bwd inputs on several devices, teacher on "
                         f"{lt.device}")
    student = ls.dtype
    lt, ls, (entry, counter) = _logits(lt, ls)
    lse_t, lse_s = _check(lse_t, "lse_t"), _check(lse_s, "lse_s")
    g = _check(g, "row gradient")
    rows, vocab = lt.shape
    dls = torch.empty_like(ls)
    rc = getattr(build.library(), "kd_kl_bwd_" + entry)(
        lt.data_ptr(), ls.data_ptr(), lse_t.data_ptr(), lse_s.data_ptr(),
        g.data_ptr(), dls.data_ptr(), rows, vocab, 1.0 / temperature,
        float(temperature), build.stream_of(lt))
    build.check(rc, "kd_kl_bwd" + counter)
    LAUNCHES["kd_kl_bwd" + counter] += 1
    return dls.to(student)


_KD_KL_BWD = define_op(
    "kd_kl_bwd", "(Tensor lt, Tensor ls, Tensor lse_t, Tensor lse_s, "
    "Tensor g, float temperature) -> Tensor",
    cpu=_kd_kl_bwd_cpu, cuda=_kd_kl_bwd_cuda,
    fake=lambda lt, ls, lse_t, lse_s, g, temperature: torch.empty_like(ls),
    cost=lambda lt, ls, lse_t, lse_s, g, temperature, out=None:
    roofline.kd_kl_bwd_cost(*lt.shape, _elt(lt, ls)))


def kd_kl_bwd(lt, ls, lse_t, lse_s, g, temperature: float) -> torch.Tensor:
    """Student gradient g·(p_S − p_T)·temp, (T, V) in the student's type;
    lse_t, lse_s and g (T,) fp32: one ``repro_torch::kd_kl_bwd``."""
    if (lt.ndim != 2 or lt.shape != ls.shape
            or any(t.shape != lt.shape[:1] for t in (lse_t, lse_s, g))):
        raise ValueError(
            f"kd_kl_bwd wants (T, V) logits and (T,) rows, got "
            f"{[tuple(t.shape) for t in (lt, ls, lse_t, lse_s, g)]}")
    return _KD_KL_BWD(lt, ls, lse_t, lse_s, g, float(temperature))


def _fold_rows(info, in_dims, *args):
    """The vmap rules' common step: each tensor argument with its vmapped
    axis moved to the front (broadcast there where it is not vmapped) and
    folded into the row axis, (B, T, ...) -> (B·T, ...).  The kernels are
    row-wise, so this is exact."""
    out = []
    for a, d in zip(args, in_dims):
        a = (a.expand((info.batch_size,) + tuple(a.shape)) if d is None
             else a.movedim(d, 0))
        out.append(a.reshape((-1,) + tuple(a.shape[2:])))
    return out


class _KdKlBwd(torch.autograd.Function):
    """B2 as a Function of its own, so that B1's backward is made of
    Functions with vmap rules and runs under ``torch.func.vmap`` of
    ``torch.func.grad`` (a kernel has no batched form of its pointers)."""

    @staticmethod
    def forward(lt, ls, lse_t, lse_s, g, temperature: float):
        return kd_kl_bwd(lt, ls, lse_t, lse_s, g.contiguous(), temperature)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, lt, ls, lse_t, lse_s, g, temperature):
        b = info.batch_size
        flat = _fold_rows(info, in_dims[:5], lt, ls, lse_t, lse_s, g)
        dls = _KdKlBwd.apply(*flat, temperature)
        return dls.reshape((b, -1) + tuple(dls.shape[1:])), 0


class _KdKlRows(torch.autograd.Function):
    """B1 forward, B2 backward; the row logsumexps ride out as outputs the
    loss does not differentiate (a Function under ``torch.func`` may save
    only its inputs and outputs)."""

    @staticmethod
    def forward(lt, ls, temperature: float):
        return kd_kl_fwd(lt, ls, temperature)

    @staticmethod
    def setup_context(ctx, inputs, output):
        lt, ls, temperature = inputs
        _, lse_t, lse_s = output
        ctx.mark_non_differentiable(lse_t, lse_s)
        ctx.save_for_backward(lt, ls, lse_t, lse_s)
        ctx.temperature = temperature

    @staticmethod
    def backward(ctx, g, _g_lse_t, _g_lse_s):
        lt, ls, lse_t, lse_s = ctx.saved_tensors
        dls = _KdKlBwd.apply(lt, ls, lse_t, lse_s, g, ctx.temperature)
        return None, dls.to(ls.dtype), None

    @staticmethod
    def vmap(info, in_dims, lt, ls, temperature):
        b = info.batch_size
        kl, lse_t, lse_s = _KdKlRows.apply(
            *_fold_rows(info, in_dims[:2], lt, ls), temperature)
        return tuple(t.reshape(b, -1) for t in (kl, lse_t, lse_s)), (0, 0, 0)


def kd_kl_loss(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
               temperature: float = 1.0) -> torch.Tensor:
    """Per-example KL(p_T‖p_S)·temp² over the last axis; leading dims kept."""
    shape = teacher_logits.shape
    if shape != student_logits.shape:
        raise ValueError(f"teacher {tuple(shape)} vs student "
                         f"{tuple(student_logits.shape)}")
    lt = teacher_logits.detach().reshape(-1, shape[-1])
    ls = student_logits.reshape(-1, shape[-1])
    return _KdKlRows.apply(lt, ls, float(temperature))[0].reshape(shape[:-1])


def _row_lse_cuda(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    logits = _check(logits, "logits", tuple(_FORMS))
    entry, counter = _FORMS[logits.dtype]
    rows, vocab = logits.shape
    out = torch.empty(rows, device=logits.device)
    rc = getattr(build.library(), "row_lse_" + entry)(
        logits.data_ptr(), out.data_ptr(), rows, vocab, 1.0 / temperature,
        build.stream_of(logits))
    build.check(rc, "row_logsumexp" + counter)
    LAUNCHES["row_logsumexp" + counter] += 1
    return out


_ROW_LSE = define_op(
    "row_lse_fwd", "(Tensor logits, float temperature) -> Tensor",
    cpu=ref.row_logsumexp_ref, cuda=_row_lse_cuda,
    fake=lambda logits, temperature: logits.new_empty(
        logits.shape[:1], dtype=torch.float32),
    cost=lambda logits, temperature, out=None: roofline.row_lse_cost(
        *logits.shape, _elt(logits)))


def row_lse_fwd(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """(T, V) fp32 or bf16 -> (T,) logsumexp(l / temperature), fp32: one
    ``repro_torch::row_lse_fwd``."""
    if logits.ndim != 2:
        raise ValueError(f"row_logsumexp wants (T, V), got {tuple(logits.shape)}")
    return _ROW_LSE(logits, float(temperature))


class _RowLogsumexp(torch.autograd.Function):
    @staticmethod
    def forward(logits, temperature: float):
        return row_lse_fwd(logits, temperature)

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, temperature = inputs
        ctx.save_for_backward(logits, output)
        ctx.temperature = temperature

    @staticmethod
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        t = ctx.temperature
        # in place after the first op: one (T, V) temporary, not four
        grad = (logits.to(torch.float32) / t).sub_(lse[:, None]).exp_()
        return grad.mul_((g / t)[:, None]).to(logits.dtype), None

    @staticmethod
    def vmap(info, in_dims, logits, temperature):
        (flat,) = _fold_rows(info, in_dims[:1], logits)
        return _RowLogsumexp.apply(flat, temperature).reshape(
            info.batch_size, -1), 0


def row_logsumexp(logits: torch.Tensor, *, temperature: float = 1.0) -> torch.Tensor:
    """Row logsumexp of ``logits / temperature``: (T, V) -> (T,), fp32."""
    return _RowLogsumexp.apply(logits, float(temperature))
