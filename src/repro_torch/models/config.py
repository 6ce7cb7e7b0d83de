"""ModelConfig: the architecture description the model stack reads.

The port of ``repro.models.config.ModelConfig`` (the reference module
imports ``jax.numpy``, so the port keeps its own; ``MLAConfig`` is the
port's, in ``models.attention``).  All of the reference's families: dense
(GQA attention; the GELU or SwiGLU MLP), MoE (``moe``: a ``MoEConfig``;
``first_k_dense`` dense layers before the MoE layers; ``moe_group_size``
tokens a dispatch group; DeepSeek-V3's multi-token prediction head of
``mtp_depth``), MLA attention (``attn_type="mla"`` with an ``MLAConfig``:
deepseek-v3), SSM (Mamba-2, attention-free, no MLP), hybrid (Zamba2:
Mamba-2 layers with one shared attention + MLP block applied every
``shared_attn_period`` of them), encoder-decoder (``enc_layers`` > 0: a
bidirectional encoder over frontend embeddings and decoder layers with
cross-attention; seamless-m4t) and the frontend families (``frontend``
"audio" or "vision", ``frontend_seq`` positions of precomputed
embeddings: the encoder's input, or a prefix of the decoder's; the
frontends themselves are stubs, as in the reference), each with LayerNorm
or RMSNorm and a tied or untied LM head.  As in the reference, a config
without a ``MoEConfig`` builds dense layers whatever its family says.
``param_dtype`` and ``activation_dtype`` are float32 or bfloat16 (every
published LM config is bf16); ``pdtype`` and ``adtype`` give them as
torch dtypes.  The reference's logit soft cap, ``scan_layers`` and the
attention and residual sharding axes wait for a config that sets them.
There is no ``use_pallas``: in the port the device picks between a kernel
and its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.attention import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention
    attn_type: str = "gqa"         # gqa | mla | none
    attn_window: Optional[int] = None   # sliding-window size
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    use_rope: bool = True

    # MoE
    moe: Optional[MoEConfig] = None
    first_k_dense: int = 0         # leading dense layers before MoE layers

    # MLA
    mla: Optional[MLAConfig] = None

    # SSM / hybrid
    ssm: Optional[SSMConfig] = None
    shared_attn_period: int = 0    # hybrid: shared attn block every N ssm layers

    # encoder-decoder
    enc_layers: int = 0            # >0 -> enc-dec; encoder is bidirectional

    # modality frontend (stubbed): tokens replaced/prefixed by embeddings
    frontend: Optional[str] = None  # None | "audio" | "vision"
    frontend_seq: int = 0           # frontend embedding positions (0: the
    #                                 frontend's default, frontends.py)

    # norm / act / embeddings
    norm: str = "rms"              # rms | ln
    act: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = True

    # MTP (DeepSeek-V3 multi-token prediction): extra head depth
    mtp_depth: int = 0

    # execution
    param_dtype: str = "float32"   # float32 | bfloat16
    activation_dtype: str = "float32"
    remat: bool = False            # recompute each layer in the backward
    moe_group_size: int = 4096     # tokens a MoE dispatch group

    def __post_init__(self):
        ported = {"family": ("dense", "moe", "ssm", "hybrid", "encdec",
                             "vlm", "audio"),
                  "attn_type": ("gqa", "mla", "none"), "norm": ("ln", "rms"),
                  "act": ("gelu", "swiglu"),
                  "frontend": (None, "audio", "vision"),
                  "param_dtype": tuple(_DTYPES),
                  "activation_dtype": tuple(_DTYPES)}
        for field, allowed in ported.items():
            if getattr(self, field) not in allowed:
                raise ValueError(f"ModelConfig {field}="
                                 f"{getattr(self, field)!r} not in {allowed}")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"family={self.family!r} needs an SSMConfig")
        if self.attn_type == "mla" and self.mla is None:
            raise ValueError("attn_type='mla' needs an MLAConfig")

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
        """Homogeneous layer runs, in order: one mamba run (the hybrid's
        shared block is applied between its mamba layers), ``first_k_dense``
        dense layers then a moe run where there is a ``MoEConfig``, or one
        dense run."""
        if self.family in ("ssm", "hybrid"):
            return [("mamba", self.n_layers)]
        if self.moe is not None:
            segs = []
            if self.first_k_dense:
                segs.append(("dense", self.first_k_dense))
            segs.append(("moe", self.n_layers - self.first_k_dense))
            return segs
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
        if self.attn_type == "mla":
            m = self.mla
            attn = (d * m.q_lora_rank + m.q_lora_rank * m.n_heads
                    * (m.qk_nope_dim + m.qk_rope_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * m.n_heads
                    * (m.qk_nope_dim + m.v_head_dim)
                    + m.n_heads * m.v_head_dim * d)
        else:
            attn = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                    + self.n_heads * hd * d)
        mlp = (3 if self.act == "swiglu" else 2) * d * self.d_ff
        for kind, count in self.segments():
            if kind == "dense":
                total += count * (attn + mlp + 2 * d)
            elif kind == "moe":
                m = self.moe
                routed = m.n_experts * 3 * d * m.d_ff + d * m.n_experts
                shared = m.n_shared_experts * 3 * d * (m.shared_d_ff or m.d_ff)
                total += count * (attn + routed + shared + 2 * d)
            else:
                s = self.ssm
                di, g, n = s.d_inner, s.n_groups, s.d_state
                per = (d * (2 * di + 2 * g * n + s.n_heads)       # in_proj
                       + s.d_conv * (di + 2 * g * n)              # conv
                       + di * d + 2 * s.n_heads + di + d)         # out_proj+A/D/norm
                total += count * per
        if self.family == "hybrid" and self.shared_attn_period:
            total += attn + mlp + 2 * d + 2 * d * d
        if self.mtp_depth:
            # proj(2d->d) + one dense block + 3 norms
            total += self.mtp_depth * (2 * d * d + attn + mlp + 5 * d)
        if self.enc_layers:
            # encoder self-attn+mlp and decoder cross-attn
            total += self.enc_layers * (attn + mlp + 2 * d)
            total += self.n_layers * (attn + d)
        return int(total)

    def active_param_count(self) -> int:
        """Per-token active parameters: a MoE layer counts its top-k
        experts only."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full_moe = m.n_experts * 3 * self.d_model * m.d_ff
        active_moe = m.top_k * 3 * self.d_model * m.d_ff
        n_moe_layers = self.n_layers - self.first_k_dense
        return self.param_count() - n_moe_layers * (full_moe - active_moe)
