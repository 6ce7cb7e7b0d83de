"""The architecture registry, the input shapes, the input specs and the
smoke reduction.

The port of ``repro.configs.base`` without JAX: ``InputShape``,
``SHAPES``, the registry (``register``, ``get_config``,
``get_smoke_config``, ``list_archs``), the input specs
(``train_input_specs``, ``decode_input_specs``, ``input_specs``) and
``reduce_for_smoke``.  Every
name of ``ALL_ARCHS`` is registered: the dense phi4-mini-3.8b,
minitron-4b, granite-34b and internlm2-20b, the MoE mixtral-8x7b and
deepseek-v3-671b (MLA), the SSM mamba2-2.7b, the hybrid zamba2-1.2b, the
audio encoder-decoder seamless-m4t-large-v2 and the VLM llava-next-34b.
The input specs are the reference's ``jax.ShapeDtypeStruct`` stand-ins as
tensors on the meta device (by default): the shapes and dtypes of a
step's inputs at a ``SHAPES`` entry, allocating nothing, for the dry-run
(``launch.dryrun_lib``).  The FULL configs run at full depth only there;
the functional tests run the smoke configs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.models import frontends, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import SMOKE_FRONTEND_SEQ

META = torch.device("meta")


class InputShape(NamedTuple):
    name: str
    seq_len: int
    global_batch: int
    mode: str               # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}

ALL_ARCHS = [
    "seamless-m4t-large-v2", "minitron-4b", "granite-34b", "mixtral-8x7b",
    "phi4-mini-3.8b", "internlm2-20b", "mamba2-2.7b", "deepseek-v3-671b",
    "zamba2-1.2b", "llava-next-34b",
]


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_config(name: str) -> ModelConfig:
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ModelConfig:
    return _SMOKE[name]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# input specs: meta tensors of the inputs' shapes and dtypes, no allocation
# ---------------------------------------------------------------------------

def _frontend_len(cfg: ModelConfig) -> int:
    return cfg.frontend_seq or (frontends.frontend_seq(cfg.frontend)
                                if cfg.frontend else 0)


def train_input_specs(cfg: ModelConfig, shape: InputShape,
                      device=META) -> dict:
    """Inputs for train_step / prefill: {tokens, labels[, frontend/enc emb]}
    (int32 tokens and labels, embeddings in ``cfg.adtype``)."""
    b, s = shape.global_batch, shape.seq_len
    adt = cfg.adtype
    ids = dict(dtype=torch.int32, device=device)
    specs: dict = {}
    if cfg.enc_layers:
        # enc-dec: encoder consumes frontend frame embeddings, decoder `s` toks
        specs["enc_embeddings"] = torch.empty(
            (b, _frontend_len(cfg), cfg.d_model), dtype=adt, device=device)
        specs["tokens"] = torch.empty((b, s), **ids)
        specs["labels"] = torch.empty((b, s), **ids)
        return specs
    if cfg.frontend:
        fl = _frontend_len(cfg)
        specs["frontend_embeddings"] = torch.empty((b, fl, cfg.d_model),
                                                   dtype=adt, device=device)
        s_text = s - fl
        assert s_text > 0, f"{cfg.name}: seq {s} too short for frontend {fl}"
        specs["tokens"] = torch.empty((b, s_text), **ids)
        specs["labels"] = torch.empty((b, s_text), **ids)
        return specs
    specs["tokens"] = torch.empty((b, s), **ids)
    specs["labels"] = torch.empty((b, s), **ids)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: InputShape,
                       cache_dtype: torch.dtype = torch.bfloat16,
                       device=META) -> dict:
    """Inputs for serve_step: one new token + a seq_len KV/SSM cache
    (``transformer.init_cache`` on ``device``)."""
    b, s = shape.global_batch, shape.seq_len
    specs: dict = {"tokens": torch.empty((b, 1), dtype=torch.int32,
                                         device=device)}
    specs["cache"] = transformer.init_cache(cfg, b, s, cache_dtype,
                                            device=device)
    if cfg.enc_layers:
        specs["enc_out"] = torch.empty((b, _frontend_len(cfg), cfg.d_model),
                                       dtype=cfg.adtype, device=device)
    return specs


def input_specs(cfg: ModelConfig, shape_name: str, device=META) -> dict:
    shape = SHAPES[shape_name]
    if shape.mode == "decode":
        return decode_input_specs(cfg, shape, device=device)
    return train_input_specs(cfg, shape, device=device)


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a full config to the same-family smoke variant: 2 layers (4
    for the hybrid, its shared block every 2; at most 1 leading dense
    layer; 2 encoder layers), d_model 128, at most 4 experts of d_ff 64 in
    groups of 64 tokens, a small MLA, 16 frontend positions, small vocab,
    fp32 (the reference's values)."""
    kw: dict = dict(
        n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=32, d_ff=256, vocab_size=503,  # odd-ish to catch padding bugs
        param_dtype="float32", activation_dtype="float32",
        remat=False,
        first_k_dense=min(cfg.first_k_dense, 1),
        enc_layers=2 if cfg.enc_layers else 0,
        frontend_seq=SMOKE_FRONTEND_SEQ if cfg.frontend else 0,
        moe_group_size=64,
        attn_window=min(cfg.attn_window, 8) if cfg.attn_window else None,
    )
    if cfg.moe is not None:
        kw["moe"] = cfg.moe._replace(
            d_model=128, d_ff=64, n_experts=4,
            top_k=min(cfg.moe.top_k, 2), group_size=64,
            shared_d_ff=64 if cfg.moe.shared_d_ff else 0)
    if cfg.mla is not None:
        kw["mla"] = cfg.mla._replace(
            d_model=128, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
            qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = cfg.ssm._replace(d_model=128, d_state=16, head_dim=16,
                                     chunk=16)
        kw["n_layers"] = 4 if cfg.shared_attn_period else 2
    if cfg.shared_attn_period:
        kw["shared_attn_period"] = 2
    if cfg.mtp_depth:
        kw["mtp_depth"] = cfg.mtp_depth
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
