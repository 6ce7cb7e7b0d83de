"""Hand-written Hopper kernels of the port, each beside its plain version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a wrapper
adds one where it launches its CUDA kernel and nowhere else (a CPU tensor
takes the plain version and counts nothing), so a run can show that it
went through the kernels.
"""
from __future__ import annotations

LAUNCHES = {"kd_kl_fwd": 0, "kd_kl_bwd": 0, "grouped_conv_fwd": 0,
            "flash_attention_fwd": 0, "ssd_scan_fwd": 0, "row_logsumexp": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
