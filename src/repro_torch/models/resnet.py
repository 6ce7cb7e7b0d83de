"""ResNet-8 with GroupNorm — the paper's CIFAR backbone, NHWC.

The port of ResNet-8 from ``repro.models.resnet``: 3 stages × 1 basic block
(16/32/64 channels at width 16), GroupNorm with 16 channels per group.

Every function takes single-client params (conv weights ``(kh, kw, Cin,
Cout)``, input ``(N, H, W, C)``) or client-stacked params (conv weights
``(K, kh, kw, Cin, Cout)``, norms ``(K, C)``, input ``(K, B, H, W, C)``).
Both routes go through ``kernels.grouped_conv.client_batched_conv``, a
single client as K=1, so the model has one conv implementation on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.grouped_conv.ops import client_batched_conv
from repro_torch.models import layers
from repro_torch.models.layers import Params


def conv_init(generator: torch.Generator, kh: int, kw: int, cin: int,
              cout: int) -> Params:
    fan_in = kh * kw * cin
    return {"w": layers.trunc_normal(generator, (kh, kw, cin, cout),
                                     std=math.sqrt(2.0 / fan_in))}


def conv(params: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv, as JAX pads it."""
    w = params["w"].to(x.dtype)
    if w.ndim == 5:              # client-stacked (K, kh, kw, Cin, Cout)
        return client_batched_conv(x, w, stride=stride)
    return client_batched_conv(x[None], w[None], stride=stride)[0]


def _gn_groups(c: int, channels_per_group: int = 16) -> int:
    return max(1, c // channels_per_group)


def basic_block_init(generator: torch.Generator, cin: int,
                     cout: int) -> Params:
    p = {
        "conv1": conv_init(generator, 3, 3, cin, cout),
        "gn1": layers.groupnorm_init(cout),
        "conv2": conv_init(generator, 3, 3, cout, cout),
        "gn2": layers.groupnorm_init(cout),
    }
    if cin != cout:
        p["proj"] = conv_init(generator, 1, 1, cin, cout)
    return p


def basic_block(params: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    g = _gn_groups(params["gn1"]["scale"].shape[-1])
    y = conv(params["conv1"], x, stride)
    y = torch.relu(layers.groupnorm(params["gn1"], y, g))
    y = conv(params["conv2"], y, 1)
    y = layers.groupnorm(params["gn2"], y, g)
    if "proj" in params:
        x = conv(params["proj"], x, stride)
    elif stride != 1:
        x = x[..., ::stride, ::stride, :]
    return torch.relu(x + y)


def resnet8_init(generator: torch.Generator, num_classes: int,
                 width: int = 16, projection_head: bool = False) -> Params:
    """3 stages × 1 basic block, ~0.08M params at width 16.
    ``projection_head`` adds MOON's / FedGKD+'s two-layer MLP (4w -> 4w ->
    256) between the pooled features and the classifier."""
    p = {
        "stem": conv_init(generator, 3, 3, 3, width),
        "gn0": layers.groupnorm_init(width),
        "block1": basic_block_init(generator, width, width),
        "block2": basic_block_init(generator, width, 2 * width),
        "block3": basic_block_init(generator, 2 * width, 4 * width),
    }
    if projection_head:
        p["proj_head"] = {
            "fc1": layers.dense_bias_init(generator, 4 * width, 4 * width),
            "fc2": layers.dense_bias_init(generator, 4 * width, 256),
        }
    feat = 256 if projection_head else 4 * width
    p["fc"] = layers.dense_bias_init(generator, feat, num_classes)
    return p


def resnet8_features(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Penultimate features (through the projection head where the params
    have one). x: (N, H, W, 3) or stacked (K, B, H, W, 3)."""
    w = params["gn0"]["scale"].shape[-1]
    h = torch.relu(layers.groupnorm(params["gn0"], conv(params["stem"], x, 1),
                                    _gn_groups(w)))
    h = basic_block(params["block1"], h, 1)
    h = basic_block(params["block2"], h, 2)
    h = basic_block(params["block3"], h, 2)
    h = h.mean(dim=(-3, -2))
    if "proj_head" in params:
        h = torch.relu(layers.dense(params["proj_head"]["fc1"], h))
        h = layers.dense(params["proj_head"]["fc2"], h)
    return h


def resnet8_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return layers.dense(params["fc"], resnet8_features(params, x))
