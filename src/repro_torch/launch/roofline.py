"""Roofline terms of a dry-run step on one H100, and the kernels' costs.

The port of ``repro.launch.roofline`` for one NVIDIA H100 SXM (H100 80GB
HBM3) in place of the reference's TPU v5e pod:

    compute term    = FLOPs / the peak of the step's dtype
    memory term     = bytes accessed / the HBM3 rate
    collective term = 0: one card, no collective

``model_flops`` is the reference's formula: 6·N·D (training) or 2·N·D
(prefill, decode) with N the active parameters and D the tokens of the
step, a teacher forward adding 2·N·D, an MTP head 5%.

This module is also the one home of the port's kernels' cost functions:
for each of B1-B6 and B3's weight gradient the bytes it must move (each
input read once, each output written once) and the operations it must do
at a shape and element size, and the least time of that work on the card (``bound_ms``; B3, B4
and B5 in the 3xTF32 arithmetic their fp32 forms use,
``tf32x3_bound_ms``; B4's bf16 form on the bf16 tensor cores,
``bf16_flash_bound_ms``).  ``chip_smoke.py`` prints its bounds from them
and the dry-run counts each kernel launch by them (``register_kernel``,
``kernel_cost``), so every figure reads the same work whatever implements
a kernel.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np

from repro_torch.kernels.grouped_conv.ref import resolve_pads, same_pads

# NVIDIA H100 SXM peaks (data sheet): HBM3 bytes/s; fp32 FLOP/s on the CUDA
# cores; dense TF32 and bf16 FLOP/s on the tensor cores.  TF32 is off in
# the port, so an fp32 step runs at PEAK_FP32 and a bf16 one at PEAK_BF16.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
# the card the figures describe, as nvidia-smi names it, its power limit,
# and the bytes torch.cuda.get_device_properties(0).total_memory reports
# there (the dry-run's "fits")
DEVICE_NAME = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0
DEVICE_MEMORY_BYTES = 85_017_493_504
MESH = "1xH100"
PEAKS = {"bfloat16": PEAK_BF16, "float32": PEAK_FP32}


@dataclasses.dataclass
class RooflineReport:
    """The reference's report for one card: ``hlo_flops`` and ``hlo_bytes``
    are the traced step's FLOPs and bytes accessed (per device, which is
    all of them), ``collective_bytes`` and ``collective_s`` are 0 (one
    card moves nothing between cards), ``compute_s`` is taken at the peak
    of ``dtype`` (``PEAKS``)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dtype: str = "bfloat16"

    def __post_init__(self):
        self.compute_s = self.hlo_flops / PEAKS[self.dtype]
        self.memory_s = self.hlo_bytes / PEAK_BYTES
        self.collective_s = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs · chips): the share of the traced FLOPs the
        model's 6·N·D accounts for."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops_per_dev": self.hlo_flops,
            "hlo_bytes_per_dev": self.hlo_bytes,
            "collective_bytes_per_dev": self.collective_bytes,
            "useful_flops_ratio": self.useful_flops_ratio,
            "dtype": self.dtype,
        }


def model_flops(cfg, n_tokens: int, mode: str, *, with_teacher: bool = False,
                mtp: bool = False) -> float:
    """6·N·D training FLOPs (2·N·D forward-only for prefill/decode).

    N = active params; teacher forward adds +2·N·D when enabled."""
    n_active = cfg.active_param_count()
    mult = 6.0 if mode == "train" else 2.0
    total = mult * n_active * n_tokens
    if with_teacher:
        total += 2.0 * n_active * n_tokens
    if mtp and cfg.mtp_depth:
        # one extra block + head forward+backward per token (small)
        total *= 1.05
    return total


# ---------------------------------------------------------------------------
# the kernels' costs and bounds
# ---------------------------------------------------------------------------

class Cost(NamedTuple):
    """The work of one kernel call: bytes moved (inputs read once, outputs
    written once), operations (FLOP for the products), and the scratch
    bytes the launch allocates for its duration (B5's)."""
    nbytes: float
    flops: float
    scratch: float = 0.0

    def bound(self, peak: float = PEAK_FP32) -> tuple[float, str]:
        """``bound_ms`` of this work with its operations at ``peak``."""
        return bound_ms(self.nbytes, self.flops, peak)


def bound_ms(nbytes: float, ops: float,
             peak: float = PEAK_FP32) -> tuple[float, str]:
    """The least time of the work on the card: the larger of its bytes at
    the memory rate and its operations at ``peak``."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32x3_bound_ms(nbytes: float, flops: float) -> dict:
    """B3's, B4's and B5's bounds: in 3xTF32 (3 x FLOP at the TF32 peak),
    the arithmetic they use, with the fp32 CUDA-core bound beside it."""
    b, by = bound_ms(nbytes, 3 * flops, PEAK_TF32)
    return dict(bound_ms=b, bound_by=by,
                fp32_bound_ms=bound_ms(nbytes, flops)[0])


def bf16_flash_bound_ms(nbytes: float, flops: float) -> dict:
    """B4's bound on bf16 inputs: Q·Kᵀ of bf16 values is exact as one bf16
    tensor-core product (fp32 sums), and P·V with P kept in fp32 takes two
    (P's high and low bf16 halves against V), all at the bf16 peak: 1.5 x
    the FLOP (half of them in each product) at ``PEAK_BF16`` against the
    bytes.  The 3xTF32 bound of the fp32 form's arithmetic goes beside
    it."""
    b, by = bound_ms(nbytes, 1.5 * flops, PEAK_BF16)
    return dict(bound_ms=b, bound_by=by,
                tf32x3_bound_ms=tf32x3_bound_ms(nbytes, flops)["bound_ms"])


def kd_kl_fwd_cost(rows: int, vocab: int, elt: int = 4) -> Cost:
    """B1: both logits read once, three (rows,) fp32 outputs written; ~12
    operations an element (2 scalings, 2 exps, the running max/sum updates
    and the cross term)."""
    n = rows * vocab
    return Cost(2 * elt * n + 12 * rows, 12 * n)


def kd_kl_bwd_cost(rows: int, vocab: int, elt: int = 4) -> Cost:
    """B2: both logits and three (rows,) fp32 vectors read, the gradient
    written in the logits' type; ~8 operations an element (2 scalings, 2
    exps, 4 arithmetic)."""
    n = rows * vocab
    return Cost(3 * elt * n + 12 * rows, 8 * n)


def row_lse_cost(rows: int, vocab: int, elt: int = 4) -> Cost:
    """B6: the logits read once, the (rows,) fp32 logsumexp written; ~4
    operations an element (scale, compare, exp, add)."""
    n = rows * vocab
    return Cost(elt * n + 4 * rows, 4 * n)


def taps_in_bounds(size: int, k: int, stride: int, out: int, lo: int) -> int:
    """Filter taps along one axis that land inside the input, summed over
    the outputs: the kernel skips the taps that fall on SAME padding."""
    return sum(1 for o in range(out) for i in range(k)
               if 0 <= o * stride - lo + i < size)


def grouped_conv_cost(k: int, n: int, h: int, cin: int, cout: int, kk: int,
                      stride: int) -> Cost:
    """B3 at SAME padding on square (K, N, H, H, Cin) fp32 input with K
    clients' (kk, kk, Cin, Cout) filters: input, filters and output once;
    the multiply-adds of the taps inside the input only."""
    oh, lo, _ = same_pads(h, kk, stride)
    nbytes = 4 * (k * n * h * h * cin + k * kk * kk * cin * cout
                  + k * n * oh * oh * cout)
    flops = 2 * k * n * cout * cin * taps_in_bounds(h, kk, stride, oh, lo) ** 2
    return Cost(nbytes, flops)


def grouped_conv_dw_cost(k: int, n: int, h: int, w: int, cin: int,
                         cout: int, kh: int, kw: int, stride: int,
                         padding: str = "SAME") -> Cost:
    """B3's weight gradient of x (K, N, H, W, Cin) fp32 against dy (K, N,
    OH, OW, Cout): x and dy read once, the (K, kh, kw, Cin, Cout) filter
    gradient written once; the multiply-adds of the taps inside the input
    only, the forward's."""
    oh, lo_h, _ = resolve_pads(h, kh, stride, padding)
    ow, lo_w, _ = resolve_pads(w, kw, stride, padding)
    nbytes = 4 * (k * n * h * w * cin + k * n * oh * ow * cout
                  + k * kh * kw * cin * cout)
    flops = (2 * k * n * cout * cin * taps_in_bounds(h, kh, stride, oh, lo_h)
             * taps_in_bounds(w, kw, stride, ow, lo_w))
    return Cost(nbytes, flops)


@functools.lru_cache(maxsize=256)
def attended_pairs(sq: int, skv: int, causal: bool,
                   window: Optional[int] = None) -> int:
    """(query, key) pairs the mask keeps: key j <= query i (and with a
    window j > i - window) under ``causal``, every pair otherwise."""
    if not causal:
        return sq * skv
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_cost(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
               causal: bool = True, window: Optional[int] = None,
               elt: int = 4) -> Cost:
    """B4: q, k, v read once (k and v at Hkv heads), o written once; 4·D
    FLOP an attended (query, key) pair and query head (Q·Kᵀ and P·V)."""
    nbytes = elt * (2 * b * sq * hq * d + 2 * b * skv * hkv * d)
    return Cost(nbytes, 4 * d * attended_pairs(sq, skv, causal, window)
                * b * hq)


def ssd_cost(b: int, l: int, h: int, p: int, g: int, n: int, q: int,
             elt: int = 4, init_state: bool = False) -> Cost:
    """B5: x, y, dt, A, B, C and the final state once each (x, y, B and C
    at ``elt`` bytes, the rest fp32; the entering state too where one is
    given).  Per chunk of r rows, over its r(r+1)/2 pairs i >= j:
    2·pairs·N for C·Bᵀ once per (batch, B/C group), since every head of a
    group shares it (the function needs it once, whatever implements it);
    per (batch, head) 2·pairs·P for the weighted x, plus 2·r·N·P each for
    C·Sᵀ and the state update."""
    nbytes = (elt * (2 * b * l * h * p + 2 * b * l * g * n)
              + 4 * (b * l * h + h + b * h * p * n * (2 if init_state else 1)))
    flops = 0.0
    for c0 in range(0, l, q):
        r = min(q, l - c0)
        pairs = r * (r + 1) // 2
        flops += g * 2 * pairs * n + h * (2 * pairs * p + 4 * r * n * p)
    return Cost(nbytes, flops * b)


# custom op (an ``OpOverloadPacket``) -> cost(*args, out=...) -> Cost: the
# kernels' launch functions register here (kernels/*/ops.py), and the
# dry-run's op statistics and flop count read one launch as one operation
_KERNEL_OPS: dict = {}


def register_kernel(op, cost: Callable[..., Cost]) -> None:
    """Count each call of the custom op ``op`` by ``cost(*args, out=out)``
    in the dry-run: its FLOP in ``FlopCounterMode`` and its bytes and
    scratch in ``op_stats.OpStats``."""
    from torch.utils.flop_counter import register_flop_formula

    _KERNEL_OPS[op] = cost
    register_flop_formula(op, get_raw=True)(
        lambda *args, out_val=None, **kwargs: int(cost(*args, out=out_val)
                                                  .flops))


def kernel_cost(packet, args, out) -> Optional[Cost]:
    """The cost of one call of a registered kernel op, or None for any
    other op."""
    cost = _KERNEL_OPS.get(packet)
    return None if cost is None else cost(*args, out=out)
