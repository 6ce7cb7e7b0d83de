"""What both references share: nested-dict helpers, the precision they run
in, the FedGKD loss terms and the per-leaf norms that are compared."""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F

from cardbench.frozen import layouts


def leaves(tree: dict) -> list:
    return [t for _, t in layouts.paths(tree)]


def rebuild(tree: dict, new: list) -> dict:
    out: dict = {}
    for (path, _), t in zip(layouts.paths(tree), new):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def tree_map(f: Callable, tree: dict, *rest: dict) -> dict:
    others = [leaves(r) for r in rest]
    return rebuild(tree, [f(*xs) for xs in zip(leaves(tree), *others)])


def leaf_norms(tree: dict, lead: int = 0) -> torch.Tensor:
    """The L2 norm of every leaf, in fp32, stacked: (n_leaves,), or with
    ``lead`` client-stacked axes (K, n_leaves)."""
    out = []
    for t in leaves(tree):
        t = t.to(torch.float32)
        out.append(torch.linalg.vector_norm(
            t.reshape(t.shape[:lead] + (-1,)), dim=-1))
    return torch.stack(out, dim=-1)


def change_norms(tree: dict, layout: dict, seed: int,
                 lead: int = 0) -> torch.Tensor:
    """``leaf_norms`` of ``tree`` less the initial weights, each leaf drawn
    again from the seed (no second copy of the model is kept)."""
    out = []
    for (path, _), t in zip(layouts.paths(layout), leaves(tree)):
        init = layouts.draw_leaf(layout, seed, path, t.device, torch.float32)
        d = t.to(torch.float32) - init
        out.append(torch.linalg.vector_norm(
            d.reshape(d.shape[:lead] + (-1,)), dim=-1))
        del init, d
    return torch.stack(out, dim=-1)


@contextlib.contextmanager
def precision(name: str):
    """``"fp32"``: fp32 products with TF32 off (the reference);
    ``"tf32"``: the same on the TF32 tensor cores (the fp32 cell's
    control).  cuDNN picks deterministic algorithms either way, so one
    seed reads the same twice.  The flags are restored on exit."""
    if name not in ("fp32", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    b = torch.backends
    flags = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic)
    on = name == "tf32"
    b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = on, on
    b.cudnn.deterministic = True
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic) = flags


def kl_rows(teacher_logits: torch.Tensor,
            student_logits: torch.Tensor) -> torch.Tensor:
    """KL(p_T ‖ p_S) of each row, fp32."""
    lt = F.log_softmax(teacher_logits.to(torch.float32), dim=-1)
    ls = F.log_softmax(student_logits.to(torch.float32), dim=-1)
    return torch.sum(lt.exp() * (lt - ls), dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the rows, fp32."""
    return F.cross_entropy(logits.to(torch.float32), labels.to(torch.int64))
