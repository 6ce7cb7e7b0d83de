"""Hand-written Hopper kernels of the port, each beside its plain version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a wrapper
adds one where it launches its CUDA kernel and nowhere else (a CPU tensor
takes the plain version and counts nothing), so a run can show that it
went through the kernels.  A kernel's bf16 form counts under its name
with ``_bf16``; B5 has none (its wrapper casts a bf16 caller's inputs to
fp32, and the fp32 kernels count as ``ssd_scan_fwd``).
"""
from __future__ import annotations

LAUNCHES = {"kd_kl_fwd": 0, "kd_kl_bwd": 0, "grouped_conv_fwd": 0,
            "flash_attention_fwd": 0, "ssd_scan_fwd": 0, "row_logsumexp": 0,
            "kd_kl_fwd_bf16": 0, "kd_kl_bwd_bf16": 0,
            "flash_attention_fwd_bf16": 0, "row_logsumexp_bf16": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
