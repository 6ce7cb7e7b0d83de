"""The paper's experimental configurations (Section 5.1), without JAX.

A copy of the CIFAR, Tiny-ImageNet, text and tabular tasks of
``repro.configs.paper`` and of ``distilbert_class_config``: the reference module imports
``repro.models.config`` and through it JAX, so the port keeps its own
``PaperTask`` and builds the text encoder's config from
``repro_torch.models.config``.  Datasets are synthetic stand-ins with the
paper's class counts (``repro_torch.data.synthetic``); ``scaled`` shrinks
the dataset and round counts and keeps everything else.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class PaperTask:
    name: str
    kind: str                  # "image" | "text" | "tabular"
    model: str                 # "resnet8" | "resnet50" | "mlp" | "distilbert"
    num_classes: int
    train_size: int            # paper's training-set size
    n_clients: int
    rounds: int
    local_epochs: int
    participation: float       # C
    batch_size: int = 64
    lr: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 1e-5
    optimizer: str = "sgd"
    gamma: float = 0.2         # FedGKD distillation coefficient
    buffer_m: int = 5          # FedGKD buffer
    image_hw: int = 32
    # text tasks
    seq_len: int = 64
    vocab_size: int = 2000
    d_model: int = 128
    # tabular (mlp) tasks
    feat_dim: int = 16


CIFAR10 = PaperTask("cifar10", "image", "resnet8", num_classes=10,
                    train_size=45_000, n_clients=20, rounds=100,
                    local_epochs=20, participation=0.2, gamma=0.2)
CIFAR100 = PaperTask("cifar100", "image", "resnet8", num_classes=100,
                     train_size=45_000, n_clients=20, rounds=100,
                     local_epochs=20, participation=0.2, gamma=0.2)
TINY_IMAGENET = PaperTask("tiny-imagenet", "image", "resnet50", num_classes=200,
                          train_size=90_000, n_clients=20, rounds=30,
                          local_epochs=20, participation=0.2, gamma=0.1,
                          image_hw=64)
AG_NEWS = PaperTask("ag-news", "text", "distilbert", num_classes=4,
                    train_size=60_000, n_clients=20, rounds=10,
                    local_epochs=1, participation=0.2, optimizer="adam",
                    lr=1e-5, weight_decay=0.0, gamma=0.2, buffer_m=3)
SST5 = PaperTask("sst5", "text", "distilbert", num_classes=5,
                 train_size=4_272, n_clients=10, rounds=10,
                 local_epochs=3, participation=0.4, optimizer="adam",
                 lr=1e-5, weight_decay=0.0, gamma=0.2, buffer_m=3)
# not from the paper: a light MLP workload for executor benchmarks/examples
TOY = PaperTask("toy", "tabular", "mlp", num_classes=10,
                train_size=2_000, n_clients=16, rounds=20,
                local_epochs=2, participation=0.5, batch_size=32,
                lr=0.05, weight_decay=0.0, feat_dim=16)

PAPER_TASKS = {t.name: t for t in (CIFAR10, CIFAR100, TINY_IMAGENET, AG_NEWS,
                                   SST5, TOY)}


def scaled(task: PaperTask, scale: float, rounds: Optional[int] = None,
           local_epochs: Optional[int] = None) -> PaperTask:
    """Shrink dataset size / rounds; everything else kept."""
    return dataclasses.replace(
        task,
        train_size=max(task.n_clients * 2 * task.num_classes,
                       int(task.train_size * scale)),
        rounds=rounds if rounds is not None else task.rounds,
        local_epochs=local_epochs if local_epochs is not None else task.local_epochs)


def distilbert_class_config(task: PaperTask) -> ModelConfig:
    """The DistilBERT-class text encoder of the paper's NLP tasks: 4 dense
    layers of causal GQA attention with RoPE, LayerNorm and a GELU MLP, at
    the task's width (the reference's ``distilbert_class_config``)."""
    return ModelConfig(
        name=f"distilbert-{task.name}", family="dense",
        n_layers=4, d_model=task.d_model, n_heads=4, n_kv_heads=4,
        d_ff=4 * task.d_model, vocab_size=task.vocab_size, head_dim=0,
        norm="ln", act="gelu")
