"""Classifier bundles for the paper's tasks (the port: ResNet-8 only).

A ``ModelBundle`` exposes init/apply/features so the FL algorithms can
drive a backbone.  ``client_batched`` says apply/features consume
client-stacked params natively, which unlocks the executor's
client-batched round body.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.paper import PaperTask
from repro_torch.models import resnet


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    name: str
    init: Callable              # (torch.Generator) -> params on the CPU
    apply: Callable             # (params, x) -> logits (B, C)
    features: Callable          # (params, x) -> penultimate features (B, F)
    has_projection_head: bool = False
    client_batched: bool = False


def make_model(task: PaperTask, projection_head: bool = False,
               width: int = 16) -> ModelBundle:
    """Build the paper's backbone for a task."""
    if projection_head:
        raise NotImplementedError(
            "the projection head (MOON / FedGKD+) is not ported yet "
            "(ROADMAP A8b)")
    if task.model == "resnet8":
        return ModelBundle(
            "resnet8",
            lambda gen: resnet.resnet8_init(gen, task.num_classes, width=width),
            resnet.resnet8_apply, resnet.resnet8_features,
            client_batched=True)
    raise NotImplementedError(
        f"model {task.model!r} is not ported yet (ROADMAP A8b/A9); the port "
        f"has resnet8 only")
