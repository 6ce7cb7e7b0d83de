"""The dense transformer stack, over plain-dict params.

The port of the dense family of ``repro.models.transformer``: token
embedding, ``n_layers`` pre-norm blocks of causal GQA attention and a GELU
MLP, final LayerNorm.  Parameters keep the reference's keys and layouts,
the per-layer leaves stacked on a leading layer axis under ``seg0`` (the
reference stacks them for ``lax.scan``; the port loops over that axis).

Every attention goes through ``kernels.flash_attention.ops.
flash_attention_gqa``: the CUDA kernel on a card, its plain version on the
CPU.  In the reference ``cfg.use_pallas`` picks between the Pallas kernel
and the jnp attention, two implementations of one function; here the
device picks, as it does for the port's other kernels, and the tests hold
the two to the same function.

MoE, SSM, hybrid and encoder-decoder segments, prefix embeddings, the
cross-attention input and the LM head's logits are not ported yet
(ROADMAP A15).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params
from repro_torch.tree import tree_map


def _dense_layer_init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return {"norm1": layers.layernorm_init(cfg.d_model),
            "attn": attn_lib.gqa_init(generator, cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.head_dim_,
                                      cfg.qkv_bias),
            "norm2": layers.layernorm_init(cfg.d_model),
            "mlp": layers.gelu_mlp_init(generator, cfg.d_model, cfg.d_ff)}


def _dense_layer(cfg: ModelConfig, p: Params, h: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    x = layers.layernorm(p["norm1"], h)
    h = h + attn_lib.gqa_attention(
        p["attn"], x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, positions=positions, window=cfg.attn_window,
        rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
    return h + layers.gelu_mlp(p["mlp"], layers.layernorm(p["norm2"], h))


def init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Parameters on the CPU: ``embed``, ``final_norm`` and ``seg0``, each
    leaf of which has a leading axis of ``n_layers``."""
    params: Params = {
        "embed": layers.embedding_init(generator, cfg.vocab_size, cfg.d_model),
        "final_norm": layers.layernorm_init(cfg.d_model),
    }
    for i, (_, count) in enumerate(cfg.segments()):
        per_layer = [_dense_layer_init(cfg, generator) for _ in range(count)]
        params[f"seg{i}"] = tree_map(lambda *xs: torch.stack(xs), *per_layer)
    return params


def hidden_states(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  prefix_embeddings: Optional[torch.Tensor] = None,
                  enc_out: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Final-normed hidden states (B, S, d_model) and the summed auxiliary
    loss (0 for dense layers) of int ``tokens`` (B, S)."""
    if prefix_embeddings is not None or enc_out is not None:
        raise NotImplementedError(
            "prefix embeddings and encoder outputs are not ported yet "
            "(ROADMAP A15)")
    h = layers.embed(params["embed"], tokens)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    for i, (_, count) in enumerate(cfg.segments()):
        seg = params[f"seg{i}"]
        for j in range(count):
            h = _dense_layer(cfg, tree_map(lambda x, j=j: x[j], seg), h,
                             positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return layers.layernorm(params["final_norm"], h), aux
