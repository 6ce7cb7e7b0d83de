"""The model stack over plain-dict params: dense and Mamba-2 segments.

The port of the dense and SSM families of ``repro.models.transformer``:
token embedding, the layer runs that ``ModelConfig.segments()`` yields
(pre-norm blocks of causal GQA attention and a GELU MLP, or pre-norm
residual Mamba-2 blocks), the final norm, and the logits (the tied
unembedding).  Parameters keep the reference's keys and layouts, the
per-layer leaves stacked on a leading layer axis under ``seg{i}`` (the
reference stacks them for ``lax.scan``; the port loops over that axis).
``cfg.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``), the counterpart of the reference's
per-layer ``jax.checkpoint``.

Every attention goes through ``kernels.flash_attention.ops.
flash_attention_gqa`` and every SSD scan through ``kernels.ssd_scan.ops.
ssd_scan``: the CUDA kernel on a card, its plain version on the CPU.  In
the reference ``cfg.use_pallas`` picks between the Pallas kernel and the
jnp function; here the device picks, as it does for the port's other
kernels, and the tests hold the two to the same function.

MoE, hybrid and encoder-decoder segments, SwiGLU, an untied LM head, the
logit soft cap, prefix embeddings, the cross-attention input, MTP, decode
and dtypes other than float32 are not ported yet (ROADMAP A15).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params
from repro_torch.tree import tree_map


def _check_dtypes(cfg: ModelConfig) -> None:
    for field in ("param_dtype", "activation_dtype"):
        if getattr(cfg, field) != "float32":
            raise NotImplementedError(
                f"{cfg.name}: {field}={getattr(cfg, field)!r} is not ported "
                f"yet (ROADMAP A15); the port runs float32")


def _norm_init(cfg: ModelConfig, d: int) -> Params:
    return layers.rmsnorm_init(d) if cfg.norm == "rms" \
        else layers.layernorm_init(d)


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return layers.rmsnorm(p, x) if cfg.norm == "rms" else layers.layernorm(p, x)


def _dense_layer_init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return {"norm1": _norm_init(cfg, cfg.d_model),
            "attn": attn_lib.gqa_init(generator, cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.head_dim_,
                                      cfg.qkv_bias),
            "norm2": _norm_init(cfg, cfg.d_model),
            "mlp": layers.gelu_mlp_init(generator, cfg.d_model, cfg.d_ff)}


def _dense_layer(cfg: ModelConfig, p: Params, h: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = h + attn_lib.gqa_attention(
        p["attn"], _norm(cfg, p["norm1"], h), n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
        positions=positions, window=cfg.attn_window,
        rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
    return h + layers.gelu_mlp(p["mlp"], _norm(cfg, p["norm2"], h))


def _mamba_layer_init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return {"norm": _norm_init(cfg, cfg.d_model),
            "mixer": ssm_lib.mamba2_init(generator, cfg.ssm)}


def _mamba_layer(cfg: ModelConfig, p: Params, h: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    out, _ = ssm_lib.mamba2_forward(p["mixer"], _norm(cfg, p["norm"], h),
                                    cfg.ssm)
    return h + out


_LAYER_INIT = {"dense": _dense_layer_init, "mamba": _mamba_layer_init}
_LAYER_APPLY = {"dense": _dense_layer, "mamba": _mamba_layer}


def init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Parameters on the CPU: ``embed``, ``final_norm`` and ``seg{i}``,
    each leaf of which has a leading axis of the segment's layer count."""
    _check_dtypes(cfg)
    params: Params = {
        "embed": layers.embedding_init(generator, cfg.vocab_size, cfg.d_model),
        "final_norm": _norm_init(cfg, cfg.d_model),
    }
    for i, (kind, count) in enumerate(cfg.segments()):
        per_layer = [_LAYER_INIT[kind](cfg, generator) for _ in range(count)]
        params[f"seg{i}"] = tree_map(lambda *xs: torch.stack(xs), *per_layer)
    return params


def hidden_states(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  prefix_embeddings: Optional[torch.Tensor] = None,
                  enc_out: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Final-normed hidden states (B, S, d_model) and the summed auxiliary
    loss (0 for dense and Mamba-2 layers) of int ``tokens`` (B, S)."""
    _check_dtypes(cfg)
    if prefix_embeddings is not None or enc_out is not None:
        raise NotImplementedError(
            "prefix embeddings and encoder outputs are not ported yet "
            "(ROADMAP A15)")
    h = layers.embed(params["embed"], tokens)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    for i, (kind, count) in enumerate(cfg.segments()):
        seg, apply = params[f"seg{i}"], _LAYER_APPLY[kind]
        for j in range(count):
            p = tree_map(lambda x, j=j: x[j], seg)
            if cfg.remat and torch.is_grad_enabled():
                h = checkpoint(apply, cfg, p, h, positions, use_reentrant=False)
            else:
                h = apply(cfg, p, h, positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _norm(cfg, params["final_norm"], h), aux


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    return layers.unembed(params["embed"], h).to(torch.float32)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embeddings: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward: (logits (B, S, V) fp32, auxiliary loss)."""
    h, aux = hidden_states(params, cfg, tokens, prefix_embeddings, enc_out)
    return logits_from_hidden(params, cfg, h), aux
