"""Multi-host placement for the population tier: the part a single host
needs.

The port of part of ``repro.population.placement``: the ``HostPlacement``
record (this process's rank among the hosts, validated) and
``peak_rss_mb``.  ``n_hosts == 1`` is inert.  The shard ownership and the
split of the warm cap between hosts, the filesystem allgather,
``resume_barrier``, ``confirm_resume`` and ``clear_host_payloads`` that a
run over several hosts needs are ROADMAP A13, and ``Population`` refuses
``n_hosts > 1`` until then.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HostPlacement:
    """Which slice of the population this process owns.

    Args:
      host_id: this process's rank in ``[0, n_hosts)``.
      n_hosts: participating processes (``1`` is single-host).
      exchange_dir: the shared directory of the cross-host exchange
        (required when ``n_hosts > 1``; the exchange's deadline, polling
        and telemetry fields come with it in A13).
    """

    host_id: int
    n_hosts: int
    exchange_dir: Optional[str] = None

    def __post_init__(self):
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.n_hosts}")
        if not (0 <= self.host_id < self.n_hosts):
            raise ValueError(f"host_id {self.host_id} out of range "
                             f"[0, {self.n_hosts})")
        if self.n_hosts > 1 and not self.exchange_dir:
            raise ValueError("n_hosts > 1 needs exchange_dir= (a directory "
                             "every host can read and write)")


def peak_rss_mb() -> float:
    """This process's peak resident set (VmHWM), in MB; NaN where
    ``/proc/self/status`` cannot be read."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return float("nan")
