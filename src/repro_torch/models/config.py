"""ModelConfig: the architecture description the model stack reads.

The port's copy of the fields of ``repro.models.config.ModelConfig`` that
the dense and SSM families read (the reference module imports
``jax.numpy`` and the MoE and MLA configs, so the port keeps its own).
Ported: the dense family (GQA attention, the GELU MLP) and the SSM family
(Mamba-2, attention-free, no MLP), each with LayerNorm or RMSNorm and tied
embeddings.  The MoE, hybrid and encoder-decoder families, MLA, the dense
family's SwiGLU and an untied LM head raise ``NotImplementedError`` naming
ROADMAP A15; so do parameter and activation dtypes other than float32, but
only where a model is built (``transformer.init`` and ``hidden_states``),
so that the published configs stay what they are.  The reference's logit
soft cap and ``scan_layers`` wait for a config that sets them (A15).
There is no ``use_pallas``: in the port the device picks between a kernel
and its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.ssm import SSMConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | ssm (moe | hybrid | encdec: A15)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention
    attn_type: str = "gqa"         # gqa | none (mla: A15)
    attn_window: Optional[int] = None   # sliding-window size
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    use_rope: bool = True

    # SSM
    ssm: Optional[SSMConfig] = None

    # norm / act / embeddings
    norm: str = "rms"              # rms | ln
    act: str = "swiglu"            # the dense MLP: gelu (swiglu: A15)
    tie_embeddings: bool = True    # (an untied head: A15)

    # execution
    param_dtype: str = "float32"   # float32 (others: A15)
    activation_dtype: str = "float32"
    remat: bool = False            # recompute each layer in the backward

    def __post_init__(self):
        ported = {"family": ("dense", "ssm"), "attn_type": ("gqa", "none"),
                  "norm": ("ln", "rms"), "tie_embeddings": (True,)}
        if self.family == "dense":
            ported["act"] = ("gelu",)
        for field, allowed in ported.items():
            value = getattr(self, field)
            if value not in allowed:
                raise NotImplementedError(
                    f"ModelConfig {field}={value!r} is not ported yet "
                    f"(ROADMAP A15); the port has {field} in {allowed}")
        if self.family == "ssm" and self.ssm is None:
            raise ValueError("family='ssm' needs an SSMConfig")

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def segments(self) -> list[tuple[str, int]]:
        """Homogeneous layer runs, in order: one dense or one mamba run."""
        if self.family == "ssm":
            return [("mamba", self.n_layers)]
        return [("dense", self.n_layers)]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic total parameter count, the reference's formula."""
        d, v = self.d_model, self.vocab_size
        hd = self.head_dim_
        total = v * d  # embed, tied
        attn = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * hd * d)
        mlp = 2 * d * self.d_ff  # GELU
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
        return int(total)
