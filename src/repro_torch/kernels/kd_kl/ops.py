"""Fused KD-KL loss: the CUDA kernels with an autograd rule.

``kd_kl_loss(teacher_logits, student_logits, temperature)`` takes any
``(..., V)`` shapes and returns the per-row KL(p_T‖p_S)·temp² with the
leading dims kept.  Gradients flow to the student only (the FedGKD teacher
is a frozen ensemble, Eq. 4): the backward returns no teacher gradient.

``row_logsumexp(logits, temperature=1.0)`` maps (T, V) to the (T,) fp32
logsumexp(l / T), for every T and V (the reference's Pallas kernel covers
whole blocks only); its backward is elementwise PyTorch,
g·softmax(l / T) / T.

On a CUDA tensor the wrappers launch the kernels of ``csrc/kd_kl.cu``
(built at first use) and raise if a launch fails; on a CPU tensor they take
the plain versions in ``ref.py``.  Nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.kd_kl import ref


def _check(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"kd_kl kernels take float32 {what}, got {t.dtype}")
    return t.contiguous()


def kd_kl_fwd(lt: torch.Tensor, ls: torch.Tensor, temperature: float):
    """(T, V) x (T, V) -> (kl (T,), lse_t (T,), lse_s (T,)), fp32."""
    if lt.shape != ls.shape or lt.ndim != 2:
        raise ValueError(f"kd_kl_fwd wants two (T, V) tensors, got "
                         f"{tuple(lt.shape)} and {tuple(ls.shape)}")
    if not lt.is_cuda:
        return ref.kd_kl_fwd_ref(lt, ls, temperature)
    if ls.device != lt.device:
        raise ValueError(f"teacher on {lt.device}, student on {ls.device}")
    lt, ls = _check(lt, "teacher logits"), _check(ls, "student logits")
    rows, vocab = lt.shape
    kl, lse_t, lse_s = (torch.empty(rows, device=lt.device) for _ in range(3))
    rc = build.library().kd_kl_fwd_f32(
        lt.data_ptr(), ls.data_ptr(), kl.data_ptr(), lse_t.data_ptr(),
        lse_s.data_ptr(), rows, vocab, 1.0 / temperature,
        temperature * temperature, build.stream_of(lt))
    build.check(rc, "kd_kl_fwd")
    LAUNCHES["kd_kl_fwd"] += 1
    return kl, lse_t, lse_s


def kd_kl_bwd(lt, ls, lse_t, lse_s, g, temperature: float) -> torch.Tensor:
    """Student gradient g·(p_S − p_T)·temp, (T, V) fp32."""
    if (lt.ndim != 2 or lt.shape != ls.shape
            or any(t.shape != lt.shape[:1] for t in (lse_t, lse_s, g))):
        raise ValueError(
            f"kd_kl_bwd wants (T, V) logits and (T,) rows, got "
            f"{[tuple(t.shape) for t in (lt, ls, lse_t, lse_s, g)]}")
    if not lt.is_cuda:
        return ref.kd_kl_bwd_ref(lt, ls, lse_t, lse_s, g, temperature)
    if any(t.device != lt.device for t in (ls, lse_t, lse_s, g)):
        raise ValueError(f"kd_kl_bwd inputs on several devices, teacher on "
                         f"{lt.device}")
    lt, ls = _check(lt, "teacher logits"), _check(ls, "student logits")
    lse_t, lse_s = _check(lse_t, "lse_t"), _check(lse_s, "lse_s")
    g = _check(g, "row gradient")
    rows, vocab = lt.shape
    dls = torch.empty_like(ls)
    rc = build.library().kd_kl_bwd_f32(
        lt.data_ptr(), ls.data_ptr(), lse_t.data_ptr(), lse_s.data_ptr(),
        g.data_ptr(), dls.data_ptr(), rows, vocab, 1.0 / temperature,
        float(temperature), build.stream_of(lt))
    build.check(rc, "kd_kl_bwd")
    LAUNCHES["kd_kl_bwd"] += 1
    return dls


class _KdKlRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lt, ls, temperature: float):
        kl, lse_t, lse_s = kd_kl_fwd(lt, ls, temperature)
        ctx.save_for_backward(lt, ls, lse_t, lse_s)
        ctx.temperature = temperature
        return kl

    @staticmethod
    def backward(ctx, g):
        lt, ls, lse_t, lse_s = ctx.saved_tensors
        dls = kd_kl_bwd(lt, ls, lse_t, lse_s, g.contiguous(), ctx.temperature)
        return None, dls.to(ls.dtype), None


def kd_kl_loss(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
               temperature: float = 1.0) -> torch.Tensor:
    """Per-example KL(p_T‖p_S)·temp² over the last axis; leading dims kept."""
    shape = teacher_logits.shape
    if shape != student_logits.shape:
        raise ValueError(f"teacher {tuple(shape)} vs student "
                         f"{tuple(student_logits.shape)}")
    lt = teacher_logits.detach().reshape(-1, shape[-1])
    ls = student_logits.reshape(-1, shape[-1])
    return _KdKlRows.apply(lt, ls, float(temperature)).reshape(shape[:-1])


def row_lse_fwd(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """(T, V) -> (T,) logsumexp(l / temperature), fp32."""
    if logits.ndim != 2:
        raise ValueError(f"row_logsumexp wants (T, V), got {tuple(logits.shape)}")
    if not logits.is_cuda:
        return ref.row_logsumexp_ref(logits, temperature)
    logits = _check(logits, "logits")
    rows, vocab = logits.shape
    out = torch.empty(rows, device=logits.device)
    rc = build.library().row_lse_f32(logits.data_ptr(), out.data_ptr(), rows,
                                     vocab, 1.0 / temperature,
                                     build.stream_of(logits))
    build.check(rc, "row_logsumexp")
    LAUNCHES["row_logsumexp"] += 1
    return out


class _RowLogsumexp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, temperature: float):
        lse = row_lse_fwd(logits, temperature)
        ctx.save_for_backward(logits, lse)
        ctx.temperature = temperature
        return lse

    @staticmethod
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        t = ctx.temperature
        # in place after the first op: one (T, V) temporary, not four
        grad = (logits.to(torch.float32) / t).sub_(lse[:, None]).exp_()
        return grad.mul_((g / t)[:, None]).to(logits.dtype), None


def row_logsumexp(logits: torch.Tensor, *, temperature: float = 1.0) -> torch.Tensor:
    """Row logsumexp of ``logits / temperature``: (T, V) -> (T,), fp32."""
    return _RowLogsumexp.apply(logits, float(temperature))
