"""Peaks of one NVIDIA H100 SXM and the cost of the work the cells time.

Frozen from the port's ``launch/roofline.py`` (its byte counts, its
``model_flops`` and its conv and attention costs), repriced for a yardstick
that reads the same work whatever implements it:

* an fp32 product is priced at the TF32 tensor cores' 495 TFLOP/s, the
  fastest rate at which the card multiplies fp32 operands (the port's
  3xTF32 kernels do three products for one: that is their scheme, not the
  work);
* attention's FLOP are priced at the bf16 peak with no factor for how a
  kernel splits its products (the port prices its P·V twice).

A share of a roofline is ``bound_s(work) / measured seconds``: at most 1
for any implementation of the same work.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s, TF32 and bf16 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BY_DTYPE = {"float32": PEAK_TF32, "bfloat16": PEAK_BF16}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    """The least time of the work: its bytes at the HBM rate or its FLOP at
    ``peak``, whichever is longer."""
    return max(nbytes / PEAK_BYTES, flops / peak)


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------

def dense_lm_params(d_model: int, n_layers: int, n_heads: int,
                    n_kv_heads: int, head_dim: int, d_ff: int,
                    vocab: int) -> int:
    """Parameters of a dense pre-norm decoder with tied embeddings, GQA
    without biases, a SwiGLU MLP and RMSNorm (two a layer and a final
    one)."""
    attn = 2 * d_model * n_heads * head_dim + 2 * d_model * n_kv_heads * head_dim
    layer = attn + 3 * d_model * d_ff + 2 * d_model
    return vocab * d_model + d_model + n_layers * layer


def lm_model_flops(n_params: int, n_tokens: int, mode: str,
                   with_teacher: bool = False) -> float:
    """6·N·D for a training step (2·N·D forward only), a teacher forward
    adding 2·N·D: the port's ``model_flops`` formula."""
    total = (6.0 if mode == "train" else 2.0) * n_params * n_tokens
    if with_teacher:
        total += 2.0 * n_params * n_tokens
    return total


# ---------------------------------------------------------------------------
# convolutions: ResNet-8's geometry and the work of a conv or its gradients
# ---------------------------------------------------------------------------

def same_pads(size: int, k: int, stride: int) -> tuple[int, int, int]:
    """(out, pad_lo, pad_hi) of a SAME conv along one axis, as JAX pads."""
    out = -(-size // stride)
    pad = max((out - 1) * stride + k - size, 0)
    return out, pad // 2, pad - pad // 2


def taps_in_bounds(size: int, k: int, stride: int) -> int:
    """Filter taps along one axis that land inside the input, summed over
    the outputs (taps on SAME padding multiply zeros: no work)."""
    out, lo, _ = same_pads(size, k, stride)
    return sum(1 for o in range(out) for i in range(k)
               if 0 <= o * stride - lo + i < size)


def resnet8_convs(width: int = 16, hw: int = 32, channels: int = 3):
    """ResNet-8's convs in forward order: (name, input size, Cin, Cout,
    kernel, stride)."""
    w = width
    return [("stem", hw, channels, w, 3, 1),
            ("block1.conv1", hw, w, w, 3, 1), ("block1.conv2", hw, w, w, 3, 1),
            ("block2.conv1", hw, w, 2 * w, 3, 2),
            ("block2.conv2", hw // 2, 2 * w, 2 * w, 3, 1),
            ("block2.proj", hw, w, 2 * w, 1, 2),
            ("block3.conv1", hw // 2, 2 * w, 4 * w, 3, 2),
            ("block3.conv2", hw // 4, 4 * w, 4 * w, 3, 1),
            ("block3.proj", hw // 2, 2 * w, 4 * w, 1, 2)]


def conv_flops(n: int, h: int, cin: int, cout: int, k: int,
               stride: int) -> float:
    """Multiply-adds x 2 of a SAME conv over ``n`` square images, taps
    inside the input only; the weight gradient does the same products."""
    return 2.0 * n * cin * cout * taps_in_bounds(h, k, stride) ** 2


def conv_dw_bytes(clients: int, n: int, h: int, cin: int, cout: int, k: int,
                  stride: int, elt: int = 4) -> float:
    """The client-batched weight gradient's bytes: each client's ``n``
    inputs and output gradients read once, its filter gradient written
    once."""
    oh = same_pads(h, k, stride)[0]
    return elt * clients * (n * h * h * cin + n * oh * oh * cout
                            + k * k * cin * cout)


def resnet8_forward_flops(width: int, classes: int, hw: int = 32) -> float:
    """One image's forward: every conv and the classifier."""
    return (sum(conv_flops(1, h, ci, co, k, s)
                for _, h, ci, co, k, s in resnet8_convs(width, hw))
            + 2.0 * 4 * width * classes)


def resnet8_dw_bound_s(clients: int, batch: int, width: int,
                       hw: int = 32) -> float:
    """The least time of one client-batched step's conv weight gradients
    (every conv of ResNet-8 for ``clients`` x ``batch`` images), each conv
    bounded alone at the TF32 peak or the HBM rate."""
    return sum(bound_s(conv_dw_bytes(clients, batch, h, ci, co, k, s),
                       conv_flops(clients * batch, h, ci, co, k, s), PEAK_TF32)
               for _, h, ci, co, k, s in resnet8_convs(width, hw))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attended_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps: key j <= query i under a causal
    mask with the queries at the end of the keys, every pair otherwise."""
    if not causal:
        return sq * skv
    off = skv - sq
    return sum(min(off + i + 1, skv) for i in range(sq))


def attention_fwd_cost(b: int, sq: int, skv: int, hq: int, hkv: int,
                       d: int, causal: bool, elt: int) -> tuple[float, float]:
    """(bytes, FLOP) of an attention forward: q, k, v read once (k and v at
    their Hkv heads), o written once; 4·D FLOP an attended pair and query
    head (Q·Kᵀ and P·V)."""
    nbytes = elt * (2 * b * sq * hq * d + 2 * b * skv * hkv * d)
    return nbytes, 4.0 * d * attended_pairs(sq, skv, causal) * b * hq


def attention_fwd_bound_s(b, sq, skv, hq, hkv, d, causal, dtype) -> float:
    nbytes, flops = attention_fwd_cost(b, sq, skv, hq, hkv, d, causal,
                                       ELEMENT_BYTES[dtype])
    return bound_s(nbytes, flops, PEAK_BY_DTYPE[dtype])

