"""Classifier bundles for the paper's tasks: ResNet-8 (CIFAR), ResNet-50
(Tiny-ImageNet), the DistilBERT-class text encoder (AG News, SST5) and the
TOY task's MLP.

A ``ModelBundle`` exposes init/apply/features so the FL algorithms can
drive a backbone.  ``client_batched`` says apply/features consume
client-stacked params natively, which unlocks the executor's
client-batched round body (ResNet-8 and ResNet-50).  ``vmap_friendly``
says the model is cheap to ``torch.func.vmap`` over stacked per-client
weights (the MLP: its dense layers become batched matmuls), which
``executor="auto"`` reads, as the reference's does.
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
    vmap_friendly: bool = True
    client_batched: bool = False
    # the params key of the classifier layer: ``apply`` is
    # ``layers.dense(params[head_key], features(params, x))``
    head_key: str = "fc"


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
                       projection_head, vmap_friendly=False)


def make_model(task: PaperTask, projection_head: bool = False,
               width: int = 16) -> ModelBundle:
    """Build the paper's backbone for a task (``width`` is ResNet-8's and
    sets the MLP's hidden widths, 4·width; ResNet-50 has no width knob and
    the text encoder takes its width from the task), with the MOON /
    FedGKD+ projection head where ``projection_head`` is set (the MLP has
    none, as in the reference)."""
    if task.model == "resnet8":
        return ModelBundle(
            "resnet8",
            lambda gen: resnet.resnet8_init(gen, task.num_classes, width=width,
                                            projection_head=projection_head),
            resnet.resnet8_apply, resnet.resnet8_features, projection_head,
            vmap_friendly=False, client_batched=True)
    if task.model == "resnet50":
        return ModelBundle(
            "resnet50",
            lambda gen: resnet.resnet50_init(gen, task.num_classes,
                                             projection_head=projection_head),
            resnet.resnet50_apply, resnet.resnet50_features, projection_head,
            vmap_friendly=False, client_batched=True)
    if task.model == "mlp":
        h = 4 * width                    # width=16 default -> [64, 64]
        return ModelBundle(
            "mlp",
            lambda gen: resnet.mlp_init(gen, task.feat_dim, [h, h],
                                        task.num_classes),
            resnet.mlp_apply, resnet.mlp_features, False, head_key="fc2")
    if task.model == "distilbert":
        return _text_classifier(task, projection_head)
    raise ValueError(f"unknown model {task.model!r}")
