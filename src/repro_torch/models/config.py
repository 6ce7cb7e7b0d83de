"""ModelConfig: the architecture description the transformer stack reads.

The port's copy of the fields of ``repro.models.config.ModelConfig`` that
the dense family reads (the reference module imports ``jax.numpy`` and the
MoE, SSM and MLA configs, so the port keeps its own).  Only the dense
family with GQA attention, LayerNorm and the GELU MLP is ported, in
float32 with tied embeddings (no LM head); the other families, norms and
activations raise ``NotImplementedError`` naming ROADMAP A15, and the
dtype and LM-head fields wait for the LM stack there too.  There is no
``use_pallas``: in the port the device picks the attention implementation
(``models.attention.gqa_attention``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense (moe | ssm | hybrid | encdec: A15)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention
    attn_type: str = "gqa"         # gqa (mla: A15)
    attn_window: Optional[int] = None   # sliding-window size
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    use_rope: bool = True

    # norm / act
    norm: str = "rms"              # ln (rms: A15)
    act: str = "swiglu"            # gelu (swiglu: A15)

    def __post_init__(self):
        unported = {"family": (self.family, "dense"),
                    "attn_type": (self.attn_type, "gqa"),
                    "norm": (self.norm, "ln"), "act": (self.act, "gelu")}
        for field, (value, ported) in unported.items():
            if value != ported:
                raise NotImplementedError(
                    f"ModelConfig {field}={value!r} is not ported yet "
                    f"(ROADMAP A15); the port has {field}={ported!r}")

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def segments(self) -> list[tuple[str, int]]:
        """Homogeneous layer runs, in order: one dense run."""
        return [("dense", self.n_layers)]
