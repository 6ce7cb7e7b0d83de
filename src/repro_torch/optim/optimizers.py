"""Minimal functional optimizers over nested dicts of tensors.

The port of ``repro.optim.optimizers``.  An ``Optimizer`` is (init, update):

    state = opt.init(params, lead=())
    updates, state = opt.update(grads, state, params, lr)
    params = apply_updates(params, updates)

Updates are NEGATIVE steps (add them to params).  ``lead`` is the shape of
the leading client axis of client-stacked params: every per-client scalar
of the state (Adam's step count) gets that shape, so a masked step can
keep one client's state while the others move.

Weight decay follows the reference's CODE, not its docstrings: ``sgd``
adds ``wd·p`` to the gradient (coupled L2); ``adam`` adds ``wd·p`` to the
step after bias correction.  Call ``update`` with autograd off.

SGD's state takes each parameter's dtype, and its Python-scalar
coefficients (lr, momentum, weight decay) meet a bf16 leaf as JAX's weak
types do: rounded to bf16 first (``_scalar``), so a bf16 step rounds
where the reference's does.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (updates, state)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by min(1, max_norm / (global_norm + 1e-9))."""
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


@functools.lru_cache(maxsize=64)
def _in_dtype(c: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(c, dtype=dtype))


def _scalar(c, like: torch.Tensor):
    """``c`` as JAX applies a Python scalar to an array of ``like``'s
    dtype: weakly typed, so rounded to that dtype first (momentum 0.9 is
    0.8984375 against a bf16 leaf).  A tensor, or an fp32 leaf, takes it
    as it is (the same product)."""
    if isinstance(c, torch.Tensor) or like.dtype == torch.float32:
        return c
    return _in_dtype(float(c), like.dtype)


def sgd(momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """SGD with optional heavy-ball momentum and coupled L2 weight decay —
    the paper's CV optimizer (momentum 0.9, wd 1e-5)."""

    def init(params, lead=()):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, lr):
        if weight_decay:
            grads = tree_map(lambda g, p: g + _scalar(weight_decay, g)
                             * p.to(g.dtype), grads, params)
        if momentum == 0.0:
            return tree_map(lambda g: _scalar(-lr, g) * g, grads), ()
        new_m = tree_map(lambda m, g: _scalar(momentum, g) * m.to(g.dtype) + g,
                         state, grads)
        if nesterov:
            step = tree_map(lambda g, m: g + _scalar(momentum, m) * m, grads,
                            new_m)
        else:
            step = new_m
        new_m = tree_map(lambda m, s: m.to(s.dtype), new_m, state)
        return tree_map(lambda s: _scalar(-lr, s) * s, step), new_m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: object
    nu: object
    count: torch.Tensor


def _lead_view(c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-client scalar ``lead``-shaped tensor over a leaf."""
    return c.reshape(c.shape + (1,) * (like.ndim - c.ndim))


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam — the paper's NLP optimizer (lr 1e-5, wd 0).  State in fp32."""

    def init(params, lead=()):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        device = tree_leaves(params)[0].device
        return AdamState(tree_map(z, params), tree_map(z, params),
                         torch.zeros(lead, dtype=torch.int32, device=device))

    def update(grads, state, params, lr):
        count = state.count + 1
        gf = tree_map(lambda g: g.to(torch.float32), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, gf)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                      state.nu, gf)
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)
        step = tree_map(lambda m, v: (m / _lead_view(c1, m))
                        / (torch.sqrt(v / _lead_view(c2, v)) + eps), mu, nu)
        if weight_decay:
            step = tree_map(lambda s, p: s + weight_decay * p.to(s.dtype),
                            step, params)
        return tree_map(lambda s: -lr * s, step), AdamState(mu, nu, count)

    return Optimizer(init, update)
