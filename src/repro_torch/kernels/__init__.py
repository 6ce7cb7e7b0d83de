"""Hand-written Hopper kernels of the port, each beside its plain version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a wrapper
adds one where it launches its CUDA kernel and nowhere else (a CPU tensor
takes the plain version and counts nothing), so a run can show that it
went through the kernels.  A kernel's bf16 form counts under its name
with ``_bf16``; B5 has none (its wrapper casts a bf16 caller's inputs to
fp32, and the fp32 kernels count as ``ssd_scan_fwd``).

Each launch function of B1, B2, B4, B5, B6 and B3's weight gradient is
one operator of the ``repro_torch`` library (``define_op``): its CUDA
kernel launches the kernel, its CPU kernel is the plain version, and its
fake (meta) kernel gives the outputs' shapes and types without computing
anything, so a step traced on the meta device (``launch.dryrun_lib``) sees
one operation a launch, counted by its cost function (``launch.roofline``),
where it would otherwise see the plain version's intermediates.
"""
from __future__ import annotations

from typing import Callable

import torch

LAUNCHES = {"kd_kl_fwd": 0, "kd_kl_bwd": 0, "grouped_conv_fwd": 0,
            "grouped_conv_dw": 0,
            "flash_attention_fwd": 0, "ssd_scan_fwd": 0, "row_logsumexp": 0,
            "kd_kl_fwd_bf16": 0, "kd_kl_bwd_bf16": 0,
            "flash_attention_fwd_bf16": 0, "row_logsumexp_bf16": 0}

# the kernels' operators: torch.ops.repro_torch.<name>
LIB = torch.library.Library("repro_torch", "DEF")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def define_op(name: str, schema: str, *, cpu: Callable, cuda: Callable,
              fake: Callable, cost: Callable):
    """Define ``repro_torch::<name><schema>`` with ``cpu`` (the plain
    version), ``cuda`` (the kernel's launch) and ``fake`` (the outputs'
    shapes and types), and register ``cost(*args, out=...)`` (a
    ``roofline.Cost``) as its FLOP formula and its bytes.  Returns the
    operator.  The lower-level library API, not ``torch.library.custom_op``,
    because the latter runs a Python autograd kernel and aliasing checks
    on every call, several times the dispatch's own host cost."""
    from repro_torch.launch import roofline

    LIB.define(name + schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=LIB)
    packet = getattr(torch.ops.repro_torch, name)
    roofline.register_kernel(packet, cost)
    return packet.default
