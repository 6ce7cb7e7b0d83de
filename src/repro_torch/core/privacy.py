"""Differential privacy, DP-FedAvg style (McMahan et al. 2018).

The port of ``repro.core.privacy``.  Client model deltas are L2-clipped
(``privatize_uploads``) and Gaussian noise is added once to the aggregate
(``noise_aggregate``).  FedGKD's teacher is built from past, already
noised, global models, so the KD term composes with DP at no extra privacy
cost.

Usage:  ``fl_loop.run_federated(..., dp=DPConfig(clip_norm=1.0,
noise_multiplier=0.5))``.

The noise: ``DPConfig.noise`` is ``noise(round_idx, params) -> [z]``, one
standard-normal fp32 tensor per leaf of ``params`` in flatten order.  Where
it is not given, the draws come from a CPU ``torch.Generator`` seeded from
``(dp.seed, round_idx)`` and are moved to the params' device, so the card
and the CPU add the same noise.  The reference draws with ``jax.random``,
which torch cannot replay; its draws can be fed through ``noise``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.optim import global_norm
from repro_torch.tree import tree_flatten, tree_map


@dataclasses.dataclass(frozen=True)
class DPConfig:
    clip_norm: float = 1.0         # per-client delta L2 bound C
    noise_multiplier: float = 0.5  # σ; noise std = σ·C / n_sampled
    seed: int = 0
    noise: Optional[Callable] = dataclasses.field(default=None, compare=False)

    def noise_std(self, n_sampled: int) -> float:
        return self.noise_multiplier * self.clip_norm / max(1, n_sampled)


def clip_delta(new_params: Any, anchor: Any, clip_norm: float) -> Any:
    """anchor + clip(new − anchor): the update, L2-bounded."""
    delta = tree_map(lambda a, b: a.to(torch.float32) - b.to(torch.float32),
                     new_params, anchor)
    scale = torch.clamp(clip_norm / (global_norm(delta) + 1e-12), max=1.0)
    return tree_map(lambda b, d: (b.to(torch.float32) + scale * d).to(b.dtype),
                    anchor, delta)


def generator_noise(seed: int, round_idx: int, params: Any) -> list:
    """The default draws: one CPU generator for the round, a leaf at a
    time in flatten order, each moved to its leaf's device."""
    gen = torch.Generator().manual_seed((seed << 32) + round_idx)
    return [torch.randn(tuple(x.shape), generator=gen).to(x.device)
            for x in tree_flatten(params)[0]]


def add_noise(params: Any, std: float, draws: list) -> Any:
    """params + std·z, leafwise in fp32, ``draws`` in flatten order."""
    leaves, rebuild = tree_flatten(params)
    if len(draws) != len(leaves):
        raise ValueError(f"{len(draws)} noise draws for {len(leaves)} leaves")
    return rebuild([(x.to(torch.float32) + std * z.to(x.device, torch.float32))
                    .to(x.dtype) for x, z in zip(leaves, draws)])


def privatize_uploads(uploads: list[dict], anchor: Any, dp: DPConfig,
                      round_idx: int) -> list[dict]:
    """Clip every client's delta; the noise is added once to the aggregate
    by ``noise_aggregate`` (equivalent under a weighted mean, cheaper)."""
    del round_idx
    return [dict(u, params=clip_delta(u["params"], anchor, dp.clip_norm))
            for u in uploads]


def noise_aggregate(aggregated: Any, dp: DPConfig, n_sampled: int,
                    round_idx: int) -> Any:
    draws = (dp.noise(round_idx, aggregated) if dp.noise is not None
             else generator_noise(dp.seed, round_idx, aggregated))
    return add_noise(aggregated, dp.noise_std(n_sampled), draws)
