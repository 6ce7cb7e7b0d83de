"""The comparison that decides ``correct``: the port's readings of its
first rounds against the reference's, each as one number.

* ``loss_gap``, ``kd_gap``, ``eval_gap``: the largest relative gap of a
  loss (a local step's, or a round's mean where the entry reads that),
  of a step's KD term, and of an evaluation's CE.  The KD term is
  compared from round 2 on: in round 1 the teacher is every client's
  starting model, so a client's first step distils from itself (KD and
  its gradient 0) and its next ones from a model a step away (KD at the
  size of rounding).
* ``grad_gap``, ``grad2_gap``, ``delta_gap``, ``teacher_gap``: norms
  compared by the worst leaf, the gap between the port's norm and the
  reference's over the reference's norm of that leaf or of the median
  leaf, whichever is larger: each client's first gradient in round 1
  (``grad_gap``, the CE's alone) and in the rounds after it
  (``grad2_gap``, the KD's gradient in it); the global model's change
  from the initial weights after the compared rounds; the teacher's
  change in each round it is compared.  Leaves whose reference gradient is under a
  thousandth of the median leaf's are left out of the changes (round-off
  alone moves them).
"""
from __future__ import annotations

import math

import torch

QUIET_LEAF = 1e-3


def rel_gap(prog: torch.Tensor, ref: torch.Tensor, skip_zero: bool = False
            ) -> float:
    prog, ref = prog.to(torch.float64), ref.to(torch.float64)
    if prog.shape != ref.shape:
        return math.inf
    keep = ref.abs() > 0 if skip_zero else torch.ones_like(ref, dtype=bool)
    if not keep.any():
        return 0.0
    gap = (prog - ref).abs() / ref.abs().clamp(min=1e-30)
    gap = torch.where(torch.isfinite(prog), gap, torch.full_like(gap, math.inf))
    return float(gap[keep].max())


def norm_gap(prog: torch.Tensor, ref: torch.Tensor,
             keep: "torch.Tensor | None" = None) -> float:
    """Worst leaf over the last axis (leaves), every leading row (client or
    round) on its own median."""
    prog, ref = prog.to(torch.float64), ref.to(torch.float64)
    if prog.shape != ref.shape:
        return math.inf
    if prog.numel() == 0:
        return 0.0
    floor = ref.median(dim=-1, keepdim=True).values
    gap = (prog - ref).abs() / torch.maximum(ref, floor).clamp(min=1e-30)
    gap = torch.where(torch.isfinite(prog), gap, torch.full_like(gap, math.inf))
    if keep is not None:
        gap = gap[..., keep]
    return float(gap.max()) if gap.numel() else 0.0


def moving_leaves(ref_grad1: torch.Tensor) -> torch.Tensor:
    """Leaves whose reference gradient reaches a thousandth of the median
    leaf's, for some client."""
    g = ref_grad1.to(torch.float64).reshape(-1, ref_grad1.shape[-1])
    med = g.median(dim=-1, keepdim=True).values
    return (g >= QUIET_LEAF * med).any(dim=0)


def gaps(prog: dict, ref: dict) -> dict:
    """Every number of the comparison that both sides read."""
    keep = moving_leaves(ref["grad1"])
    out = {"loss_gap": rel_gap(prog["loss"], ref["loss"]),
           "grad_gap": norm_gap(prog["grad1"][:1], ref["grad1"][:1]),
           "grad2_gap": norm_gap(prog["grad1"][1:], ref["grad1"][1:]),
           "delta_gap": norm_gap(prog["delta"], ref["delta"], keep),
           "teacher_gap": norm_gap(prog["teacher"], ref["teacher"], keep),
           "eval_gap": rel_gap(prog["eval_loss"], ref["eval_loss"])}
    if "kd" in ref:
        out["kd_gap"] = rel_gap(prog["kd"][1:], ref["kd"][1:],
                                skip_zero=True)
    return out
