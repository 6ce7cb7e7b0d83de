"""ResNet-8 / ResNet-50 with GroupNorm — the paper's CV backbones, NHWC —
and the TOY task's MLP.

The port of ``repro.models.resnet``: ResNet-8 is 3 stages × 1 basic block
(16/32/64 channels at width 16), the paper's CIFAR net; ResNet-50 the
standard bottleneck stages [3, 4, 6, 3] behind a 7×7 stride-2 stem and a
3×3 stride-2 max-pool, the paper's Tiny-ImageNet net.  GroupNorm with 16
channels per group throughout.

Every function takes single-client params (conv weights ``(kh, kw, Cin,
Cout)``, input ``(N, H, W, C)``) or client-stacked params (conv weights
``(K, kh, kw, Cin, Cout)``, norms ``(K, C)``, input ``(K, B, H, W, C)``).
Both routes go through ``kernels.grouped_conv.client_batched_conv``, a
single client as K=1, so the model has one conv implementation on the card;
under ``torch.func.vmap`` the conv's vmap rule folds the vmapped axis into
K, so a vmapped single-client model is one K-client launch per conv.
"""
from __future__ import annotations

import math
from typing import Sequence

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
    """SAME conv, as JAX pads it (``lo = pad // 2``, the rest after)."""
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


# ---------------------------------------------------------------------------

def bottleneck_init(generator: torch.Generator, cin: int,
                    cmid: int) -> Params:
    cout = 4 * cmid
    p = {
        "conv1": conv_init(generator, 1, 1, cin, cmid),
        "gn1": layers.groupnorm_init(cmid),
        "conv2": conv_init(generator, 3, 3, cmid, cmid),
        "gn2": layers.groupnorm_init(cmid),
        "conv3": conv_init(generator, 1, 1, cmid, cout),
        "gn3": layers.groupnorm_init(cout),
    }
    if cin != cout:
        p["proj"] = conv_init(generator, 1, 1, cin, cout)
    return p


def bottleneck(params: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """1x1 -> 3x3 (carrying the stride) -> 1x1 x4, plus the shortcut: the
    ``proj`` 1x1 conv at the same stride where the channels change."""
    c1 = params["gn1"]["scale"].shape[-1]
    c3 = params["gn3"]["scale"].shape[-1]
    y = torch.relu(layers.groupnorm(params["gn1"], conv(params["conv1"], x, 1),
                                    _gn_groups(c1)))
    y = torch.relu(layers.groupnorm(params["gn2"],
                                    conv(params["conv2"], y, stride),
                                    _gn_groups(c1)))
    y = layers.groupnorm(params["gn3"], conv(params["conv3"], y, 1),
                         _gn_groups(c3))
    if "proj" in params:
        x = conv(params["proj"], x, stride)
    return torch.relu(x + y)


R50_STAGES: Sequence[tuple[int, int]] = ((64, 3), (128, 4), (256, 6), (512, 3))


def resnet50_init(generator: torch.Generator, num_classes: int,
                  projection_head: bool = False) -> Params:
    """The standard bottleneck ResNet-50 (~23.9M params at 200 classes).
    ``projection_head`` adds MOON's / FedGKD+'s two-layer MLP (2048 ->
    2048 -> 256) between the pooled features and the classifier."""
    p: Params = {"stem": conv_init(generator, 7, 7, 3, 64),
                 "gn0": layers.groupnorm_init(64)}
    cin = 64
    for si, (cmid, blocks) in enumerate(R50_STAGES):
        for bi in range(blocks):
            p[f"s{si}b{bi}"] = bottleneck_init(generator, cin, cmid)
            cin = 4 * cmid
    if projection_head:
        p["proj_head"] = {
            "fc1": layers.dense_bias_init(generator, cin, cin),
            "fc2": layers.dense_bias_init(generator, cin, 256),
        }
    feat = 256 if projection_head else cin
    p["fc"] = layers.dense_bias_init(generator, feat, num_classes)
    return p


def resnet50_features(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Penultimate features. x: (N, H, W, 3) or stacked (K, B, H, W, 3)."""
    h = torch.relu(layers.groupnorm(params["gn0"], conv(params["stem"], x, 2),
                                    _gn_groups(64)))
    h = layers.max_pool_same(h, 3, 2)
    for si, (_, blocks) in enumerate(R50_STAGES):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            h = bottleneck(params[f"s{si}b{bi}"], h, stride)
    h = h.mean(dim=(-3, -2))
    if "proj_head" in params:
        h = torch.relu(layers.dense(params["proj_head"]["fc1"], h))
        h = layers.dense(params["proj_head"]["fc2"], h)
    return h


def resnet50_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return layers.dense(params["fc"], resnet50_features(params, x))


def resnet50_convs(hw: int) -> list[tuple[str, int, int, int, int, int]]:
    """Every conv of ``resnet50_features`` on ``hw`` x ``hw`` inputs, in
    order: (name, input size, Cin, Cout, kernel, stride) — 53 convs."""
    convs = [("stem", hw, 3, 64, 7, 2)]
    h = -(-(-(-hw // 2)) // 2)               # the stem, then the max-pool
    cin = 64
    for si, (cmid, blocks) in enumerate(R50_STAGES):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            name = f"s{si}b{bi}"
            convs += [(f"{name}.conv1", h, cin, cmid, 1, 1),
                      (f"{name}.conv2", h, cmid, cmid, 3, stride)]
            if cin != 4 * cmid:
                convs.append((f"{name}.proj", h, cin, 4 * cmid, 1, stride))
            h = -(-h // stride)
            convs.append((f"{name}.conv3", h, cmid, 4 * cmid, 1, 1))
            cin = 4 * cmid
    return convs


# ---------------------------------------------------------------------------
# the small MLP of the TOY task (the paper's Fig. 5 toy example)

def mlp_init(generator: torch.Generator, d_in: int, widths: Sequence[int],
             num_classes: int) -> Params:
    dims = [d_in, *widths, num_classes]
    return {f"fc{i}": layers.dense_bias_init(generator, dims[i], dims[i + 1])
            for i in range(len(dims) - 1)}


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    h = x
    for i in range(n):
        h = layers.dense(params[f"fc{i}"], h)
        if i < n - 1:
            h = torch.relu(h)
    return h


def mlp_features(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i in range(len(params) - 1):
        h = torch.relu(layers.dense(params[f"fc{i}"], h))
    return h
