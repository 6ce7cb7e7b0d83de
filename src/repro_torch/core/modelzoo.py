"""Classifier bundles for the paper's tasks: ResNet-8 (CIFAR) and the
DistilBERT-class text encoder (AG News, SST5).

A ``ModelBundle`` exposes init/apply/features so the FL algorithms can
drive a backbone.  ``client_batched`` says apply/features consume
client-stacked params natively, which unlocks the executor's
client-batched round body (the text encoder has none, so it trains
through the sequential executor).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.paper import PaperTask, distilbert_class_config
from repro_torch.models import layers, resnet, transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    name: str
    init: Callable              # (torch.Generator) -> params on the CPU
    apply: Callable             # (params, x) -> logits (B, C)
    features: Callable          # (params, x) -> penultimate features (B, F)
    has_projection_head: bool = False
    client_batched: bool = False


def _text_classifier(task: PaperTask, projection_head: bool) -> ModelBundle:
    """The encoder's final-normed hidden states, mean-pooled over all
    tokens, then a dense layer to the classes; ``projection_head`` puts
    the MOON / FedGKD+ MLP (d -> d -> 256) before it."""
    cfg = distilbert_class_config(task)

    def init(generator):
        p = {"backbone": transformer.init(generator, cfg)}
        feat = cfg.d_model
        if projection_head:
            p["proj_head"] = {
                "fc1": layers.dense_bias_init(generator, cfg.d_model,
                                              cfg.d_model),
                "fc2": layers.dense_bias_init(generator, cfg.d_model, 256)}
            feat = 256
        p["fc"] = layers.dense_bias_init(generator, feat, task.num_classes)
        return p

    def features(params, x):
        h, _ = transformer.hidden_states(params["backbone"], cfg, x)
        h = torch.mean(h, dim=1)
        if "proj_head" in params:
            h = torch.relu(layers.dense(params["proj_head"]["fc1"], h))
            h = layers.dense(params["proj_head"]["fc2"], h)
        return h

    def apply(params, x):
        return layers.dense(params["fc"], features(params, x))

    return ModelBundle(f"distilbert-{task.name}", init, apply, features,
                       projection_head)


def make_model(task: PaperTask, projection_head: bool = False,
               width: int = 16) -> ModelBundle:
    """Build the paper's backbone for a task (``width`` is ResNet-8's; the
    text encoder takes its width from the task), with the MOON / FedGKD+
    projection head where ``projection_head`` is set."""
    if task.model == "resnet8":
        return ModelBundle(
            "resnet8",
            lambda gen: resnet.resnet8_init(gen, task.num_classes, width=width,
                                            projection_head=projection_head),
            resnet.resnet8_apply, resnet.resnet8_features, projection_head,
            client_batched=True)
    if task.model == "distilbert":
        return _text_classifier(task, projection_head)
    raise NotImplementedError(
        f"model {task.model!r} is not ported yet (ROADMAP A8b); the port "
        f"has resnet8 and distilbert")
