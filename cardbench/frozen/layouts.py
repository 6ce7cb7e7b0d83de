"""The cells' parameter layouts and their weights, drawn from the seed.

A layout is a nested dict of ``Leaf`` specs with the port's keys (the
reference package's pytree keys): shape, dtype and how the leaf is drawn.
``draw`` makes the weights on the card from a CUDA generator, one call a
leaf, in the dtype they are trained in; the harness hands the same tensors
to the port and, upcast to fp32, to the reference.  ``draw_leaf`` makes one
leaf again, so a change from the initial weights can be measured without
keeping a second copy of a model on the card.

The scales: a conv filter N(0, 2/fan_in), a dense weight N(0, 1/d_in), the
LM's token table N(0, 0.02²) (its tied logits then start near unit scale),
norm scales 1 and biases 0.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Leaf(NamedTuple):
    shape: tuple
    dtype: str
    kind: str           # "normal", "ones" or "zeros"
    std: float = 0.0


def paths(tree: dict, prefix: tuple = ()) -> list:
    """``[(path, leaf)]`` in sorted-key order (the port's flatten order)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(paths(v, prefix + (k,)) if isinstance(v, dict)
                   else [(prefix + (k,), v)])
    return out


def get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


# ---------------------------------------------------------------------------

def _conv(k: int, cin: int, cout: int) -> dict:
    return {"w": Leaf((k, k, cin, cout), "float32", "normal",
                      math.sqrt(2.0 / (k * k * cin)))}


def _gn(c: int) -> dict:
    return {"scale": Leaf((c,), "float32", "ones"),
            "bias": Leaf((c,), "float32", "zeros")}


def resnet8_layout(width: int, classes: int, channels: int = 3) -> dict:
    """ResNet-8 (3 stages of one basic block, GroupNorm), fp32."""
    w = width

    def block(cin, cout):
        b = {"conv1": _conv(3, cin, cout), "gn1": _gn(cout),
             "conv2": _conv(3, cout, cout), "gn2": _gn(cout)}
        if cin != cout:
            b["proj"] = _conv(1, cin, cout)
        return b

    return {"stem": _conv(3, channels, w), "gn0": _gn(w),
            "block1": block(w, w), "block2": block(w, 2 * w),
            "block3": block(2 * w, 4 * w),
            "fc": {"w": Leaf((4 * w, classes), "float32", "normal",
                             1.0 / math.sqrt(4 * w)),
                   "b": Leaf((classes,), "float32", "zeros")}}


def dense_lm_layout(d_model: int, n_layers: int, n_heads: int,
                    n_kv_heads: int, head_dim: int, d_ff: int, vocab: int,
                    dtype: str) -> dict:
    """A dense pre-norm decoder with tied embeddings: the layers' leaves
    stacked on a leading axis of ``n_layers`` under ``seg0``."""
    L, d = n_layers, d_model

    def dense(d_in, d_out):
        return {"w": Leaf((L, d_in, d_out), dtype, "normal",
                          1.0 / math.sqrt(d_in))}

    return {
        "embed": {"table": Leaf((vocab, d), dtype, "normal", 0.02)},
        "final_norm": {"scale": Leaf((d,), dtype, "ones")},
        "seg0": {
            "attn": {"wq": dense(d, n_heads * head_dim),
                     "wk": dense(d, n_kv_heads * head_dim),
                     "wv": dense(d, n_kv_heads * head_dim),
                     "wo": dense(n_heads * head_dim, d)},
            "mlp": {"gate": dense(d, d_ff), "up": dense(d, d_ff),
                    "down": dense(d_ff, d)},
            "norm1": {"scale": Leaf((L, d), dtype, "ones")},
            "norm2": {"scale": Leaf((L, d), dtype, "ones")},
        },
    }


# ---------------------------------------------------------------------------

def leaf_seed(seed: int, index: int) -> int:
    """A generator seed per (run seed, leaf index), under 2**63."""
    return (int(seed) * 1_000_003 + 7_919 * (index + 1)) % (2 ** 63)


def draw_leaf(layout: dict, seed: int, path: tuple, device,
              dtype: "torch.dtype | None" = None) -> torch.Tensor:
    """The leaf at ``path`` as ``draw`` makes it (in ``dtype`` where given:
    drawn in fp32, rounded to the leaf's dtype, then cast)."""
    index = [p for p, _ in paths(layout)].index(tuple(path))
    spec = get(layout, path)
    if spec.kind == "ones":
        t = torch.ones(spec.shape, dtype=DTYPES[spec.dtype], device=device)
    elif spec.kind == "zeros":
        t = torch.zeros(spec.shape, dtype=DTYPES[spec.dtype], device=device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(leaf_seed(seed, index))
        t = torch.empty(spec.shape, dtype=torch.float32, device=device)
        t.normal_(0.0, spec.std, generator=gen)
        t = t.to(DTYPES[spec.dtype])
    return t if dtype is None else t.to(dtype)


def draw(layout: dict, seed: int, device,
         dtype: "torch.dtype | None" = None) -> dict:
    """Every leaf of ``layout`` (``draw_leaf``), as a nested dict."""
    out: dict = {}
    for path, _ in paths(layout):
        _set(out, path, draw_leaf(layout, seed, path, device, dtype))
    return out
