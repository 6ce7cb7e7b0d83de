"""ModelConfig: the architecture description the model stack reads.

The port of the fields of ``repro.models.config.ModelConfig`` that the
dense, SSM and hybrid families read (the reference module imports
``jax.numpy`` and the MoE and MLA configs, so the port keeps its own).
Ported: the dense family (GQA attention; the GELU or SwiGLU MLP), the SSM
family (Mamba-2, attention-free, no MLP) and the hybrid family (Zamba2:
Mamba-2 layers with one shared attention + MLP block applied every
``shared_attn_period`` of them), each with LayerNorm or RMSNorm and a tied
or untied LM head.  The MoE family raises ``NotImplementedError`` naming
ROADMAP A15.5, MLA A15.6, and the encoder-decoder and frontend families
A15.7.  ``param_dtype`` and ``activation_dtype`` are float32 or bfloat16
(every published LM config is bf16); ``pdtype`` and ``adtype`` give them
as torch dtypes.  The reference's logit soft cap and
``scan_layers`` wait for a config that sets them.  There is no
``use_pallas``: in the port the device picks between a kernel and its
plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.ssm import SSMConfig

# what the port refuses, and the ROADMAP item that brings it
_UNPORTED = {("family", "moe"): "A15.5", ("attn_type", "mla"): "A15.6",
             ("family", "encdec"): "A15.7", ("family", "vlm"): "A15.7",
             ("family", "audio"): "A15.7"}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | ssm | hybrid (moe, encdec: A15)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention
    attn_type: str = "gqa"         # gqa | none (mla: A15.6)
    attn_window: Optional[int] = None   # sliding-window size
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    use_rope: bool = True

    # SSM / hybrid
    ssm: Optional[SSMConfig] = None
    shared_attn_period: int = 0    # hybrid: shared attn block every N ssm layers

    # norm / act / embeddings
    norm: str = "rms"              # rms | ln
    act: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = True

    # execution
    param_dtype: str = "float32"   # float32 | bfloat16
    activation_dtype: str = "float32"
    remat: bool = False            # recompute each layer in the backward

    def __post_init__(self):
        for (field, value), item in _UNPORTED.items():
            if getattr(self, field) == value:
                raise NotImplementedError(
                    f"ModelConfig {field}={value!r} is not ported yet "
                    f"(ROADMAP {item})")
        ported = {"family": ("dense", "ssm", "hybrid"),
                  "attn_type": ("gqa", "none"), "norm": ("ln", "rms"),
                  "act": ("gelu", "swiglu"),
                  "param_dtype": tuple(_DTYPES),
                  "activation_dtype": tuple(_DTYPES)}
        for field, allowed in ported.items():
            if getattr(self, field) not in allowed:
                raise ValueError(f"ModelConfig {field}="
                                 f"{getattr(self, field)!r} not in {allowed}")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"family={self.family!r} needs an SSMConfig")

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def adtype(self) -> torch.dtype:
        return _DTYPES[self.activation_dtype]

    def segments(self) -> list[tuple[str, int]]:
        """Homogeneous layer runs, in order: one dense or one mamba run (the
        hybrid's shared block is applied between its mamba layers)."""
        if self.family in ("ssm", "hybrid"):
            return [("mamba", self.n_layers)]
        return [("dense", self.n_layers)]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic total parameter count, the reference's formula."""
        d, v = self.d_model, self.vocab_size
        hd = self.head_dim_
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        attn = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * hd * d)
        mlp = (3 if self.act == "swiglu" else 2) * d * self.d_ff
        for kind, count in self.segments():
            if kind == "dense":
                total += count * (attn + mlp + 2 * d)
            else:
                s = self.ssm
                di, g, n = s.d_inner, s.n_groups, s.d_state
                per = (d * (2 * di + 2 * g * n + s.n_heads)       # in_proj
                       + s.d_conv * (di + 2 * g * n)              # conv
                       + di * d + 2 * s.n_heads + di + d)         # out_proj+A/D/norm
                total += count * per
        if self.family == "hybrid" and self.shared_attn_period:
            total += attn + mlp + 2 * d + 2 * d * d
        return int(total)
