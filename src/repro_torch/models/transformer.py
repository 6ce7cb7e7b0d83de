"""The model stack over plain-dict params: dense, MoE, Mamba-2 and hybrid LMs.

The port of the dense, MoE, SSM and hybrid families of
``repro.models.transformer``: token embedding, the layer runs that
``ModelConfig.segments()`` yields (pre-norm blocks of causal GQA attention
and a GELU or SwiGLU MLP, the same with a mixture of experts in place of
the MLP (``models.moe``), or pre-norm residual Mamba-2 blocks), for the
hybrid (Zamba2) one shared attention + MLP block applied after every
``shared_attn_period`` Mamba-2 layers to ``[h ; h0]`` projected back to
d_model (h0 the embedding stream), the final norm, and the logits (the
tied unembedding or an untied ``head``).  Parameters keep the reference's
keys and layouts, the per-layer leaves stacked on a leading layer axis
under ``seg{i}`` (the reference stacks them for ``lax.scan``; the port
loops over that axis).  ``cfg.remat`` recomputes each layer in the
backward (``torch.utils.checkpoint``), the counterpart of the reference's
per-layer ``jax.checkpoint``.  ``hidden_states`` and ``forward`` return
the MoE layers' load-balance losses summed over every layer (0 without
MoE layers).  ``mtp_logits`` is DeepSeek-V3's multi-token prediction head
(``mtp_depth``), which predicts token t+2 from the trunk's hidden state at
t and the embedding of token t+1.

Every attention of a forward goes through ``kernels.flash_attention.ops.
flash_attention_gqa`` and every SSD scan through ``kernels.ssd_scan.ops.
ssd_scan``: the CUDA kernel on a card, its plain version on the CPU.  In
the reference ``cfg.use_pallas`` picks between the Pallas kernel and the
jnp function; here the device picks, as it does for the port's other
kernels, and the tests hold the two to the same function.

Decode (``init_cache``, ``decode_step``) carries a KV cache per attention
layer (a ring buffer under a sliding window), one per application of the
hybrid's shared block, and a conv and SSM state per Mamba-2 layer; one
token's step is plain PyTorch, as in the reference, which computes it
outside any Pallas kernel.  A MoE layer's decode dispatches the B tokens
of the step as one group under the reference's capacity rule, so a token
is dropped where the reference drops it.  The caches default to bf16, as the
reference's do.

Parameters are built in ``cfg.pdtype``, the embedding is cast to
``cfg.adtype`` and the logits to fp32, as in the reference; the layers
round where the reference's round (``models.layers``).  MLA (ROADMAP
A15.6), encoder-decoder models, prefix embeddings and the cross-attention
input (A15.7) and the logit soft cap are not ported yet.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params
from repro_torch.tree import tree_map


def _norm_init(cfg: ModelConfig, d: int) -> Params:
    return layers.rmsnorm_init(d, cfg.pdtype) if cfg.norm == "rms" \
        else layers.layernorm_init(d, cfg.pdtype)


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return layers.rmsnorm(p, x) if cfg.norm == "rms" else layers.layernorm(p, x)


def _mlp_init(cfg: ModelConfig, generator: torch.Generator,
              d_ff: int) -> Params:
    if cfg.act == "swiglu":
        return layers.swiglu_init(generator, cfg.d_model, d_ff, cfg.pdtype)
    return layers.gelu_mlp_init(generator, cfg.d_model, d_ff, cfg.pdtype)


def _mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return layers.swiglu(p, x) if cfg.act == "swiglu" else layers.gelu_mlp(p, x)


def _attn_init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return attn_lib.gqa_init(generator, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim_, cfg.qkv_bias,
                             cfg.pdtype)


def _attn_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    return attn_lib.gqa_attention(
        p, x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, positions=positions, window=window,
        rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)


def _attn_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 cache: attn_lib.KVCache, window: Optional[int]):
    return attn_lib.gqa_decode_step(
        p, x, cache, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, window=window, rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope)


def _dense_layer_init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return {"norm1": _norm_init(cfg, cfg.d_model),
            "attn": _attn_init(cfg, generator),
            "norm2": _norm_init(cfg, cfg.d_model),
            "mlp": _mlp_init(cfg, generator, cfg.d_ff)}


def _dense_layer(cfg: ModelConfig, p: Params, h: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = h + _attn_apply(cfg, p["attn"], _norm(cfg, p["norm1"], h), positions,
                        cfg.attn_window)
    return h + _mlp(cfg, p["mlp"], _norm(cfg, p["norm2"], h))


def _moe_cfg(cfg: ModelConfig) -> moe_lib.MoEConfig:
    return cfg.moe._replace(group_size=cfg.moe_group_size)


def _moe_layer_init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return {"norm1": _norm_init(cfg, cfg.d_model),
            "attn": _attn_init(cfg, generator),
            "norm2": _norm_init(cfg, cfg.d_model),
            "moe": moe_lib.moe_init(generator, cfg.moe, cfg.pdtype)}


def _moe_layer(cfg: ModelConfig, p: Params, h: torch.Tensor,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, the layer's load-balance loss): the one layer with an
    auxiliary loss."""
    h = h + _attn_apply(cfg, p["attn"], _norm(cfg, p["norm1"], h), positions,
                        cfg.attn_window)
    out, aux = moe_lib.moe_apply(p["moe"], _norm(cfg, p["norm2"], h),
                                 _moe_cfg(cfg))
    return h + out, aux


def _mamba_layer_init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return {"norm": _norm_init(cfg, cfg.d_model),
            "mixer": ssm_lib.mamba2_init(generator, cfg.ssm, cfg.pdtype)}


def _mamba_layer(cfg: ModelConfig, p: Params, h: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    out, _ = ssm_lib.mamba2_forward(p["mixer"], _norm(cfg, p["norm"], h),
                                    cfg.ssm)
    return h + out


_LAYER_INIT = {"dense": _dense_layer_init, "moe": _moe_layer_init,
               "mamba": _mamba_layer_init}
_LAYER_APPLY = {"dense": _dense_layer, "moe": _moe_layer,
                "mamba": _mamba_layer}


def _hybrid(cfg: ModelConfig) -> bool:
    return cfg.family == "hybrid" and bool(cfg.shared_attn_period)


# the hybrid (Zamba2): one shared attention + MLP block applied after every
# `shared_attn_period` mamba layers; its input is [h ; h0] projected back to
# d_model (the Zamba trick of re-injecting the embedding stream)

def _shared_block_init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return {"in_proj": layers.dense_init(generator, 2 * cfg.d_model,
                                         cfg.d_model, cfg.pdtype),
            "norm1": _norm_init(cfg, cfg.d_model),
            "attn": _attn_init(cfg, generator),
            "norm2": _norm_init(cfg, cfg.d_model),
            "mlp": _mlp_init(cfg, generator, cfg.d_ff)}


def _shared_block(cfg: ModelConfig, p: Params, h: torch.Tensor,
                  h0: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    x = layers.dense(p["in_proj"], torch.cat([h, h0], dim=-1))
    x = x + _attn_apply(cfg, p["attn"], _norm(cfg, p["norm1"], x), positions,
                        None)
    x = x + _mlp(cfg, p["mlp"], _norm(cfg, p["norm2"], x))
    return h + x


def init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Parameters: ``embed``, ``final_norm``, ``seg{i}`` (each leaf with a
    leading axis of the segment's layer count), and ``head`` (untied),
    ``shared_block`` (hybrid) and ``mtp`` (``proj``, ``norm_h``, ``norm_e``,
    a dense ``block`` and ``final_norm``) where the config has them.  The
    weights are drawn on ``generator``'s device, the norms made on the CPU;
    every leaf is ``cfg.pdtype`` but the Mamba-2 layers' ``dt_bias``,
    ``A_log`` and ``D`` and the MoE routers, which are fp32."""
    params: Params = {
        "embed": layers.embedding_init(generator, cfg.vocab_size, cfg.d_model,
                                       cfg.pdtype),
        "final_norm": _norm_init(cfg, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        params["head"] = layers.dense_init(generator, cfg.d_model,
                                           cfg.vocab_size, cfg.pdtype)
    for i, (kind, count) in enumerate(cfg.segments()):
        per_layer = [_LAYER_INIT[kind](cfg, generator) for _ in range(count)]
        params[f"seg{i}"] = tree_map(lambda *xs: torch.stack(xs), *per_layer)
    if _hybrid(cfg):
        params["shared_block"] = _shared_block_init(cfg, generator)
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": layers.dense_init(generator, 2 * cfg.d_model, cfg.d_model,
                                      cfg.pdtype),
            "norm_h": _norm_init(cfg, cfg.d_model),
            "norm_e": _norm_init(cfg, cfg.d_model),
            "block": _dense_layer_init(cfg, generator),
            "final_norm": _norm_init(cfg, cfg.d_model),
        }
    return params


def _layer(tree: Any, j: int) -> Any:
    return tree_map(lambda x: x[j], tree)


def _run_layers(cfg: ModelConfig, kind: str, seg: Params, lo: int, hi: int,
                h: torch.Tensor, positions: torch.Tensor, aux: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Layers ``lo`` to ``hi`` of a stacked segment: (h, ``aux`` plus
    their load-balance losses where they are MoE layers)."""
    apply = _LAYER_APPLY[kind]
    for j in range(lo, hi):
        p = _layer(seg, j)
        if cfg.remat and torch.is_grad_enabled():
            out = checkpoint(apply, cfg, p, h, positions, use_reentrant=False)
        else:
            out = apply(cfg, p, h, positions)
        if kind == "moe":
            h, a = out
            aux = aux + a
        else:
            h = out
    return h, aux


def _hybrid_stack(cfg: ModelConfig, params: Params, h: torch.Tensor,
                  positions: torch.Tensor, aux: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Groups of ``shared_attn_period`` mamba layers, each followed by the
    shared block; then the remaining mamba layers."""
    period, seg = cfg.shared_attn_period, params["seg0"]
    groups = cfg.n_layers // period
    h0 = h
    for gi in range(groups):
        h, aux = _run_layers(cfg, "mamba", seg, gi * period,
                             (gi + 1) * period, h, positions, aux)
        if cfg.remat and torch.is_grad_enabled():
            h = checkpoint(_shared_block, cfg, params["shared_block"], h, h0,
                           positions, use_reentrant=False)
        else:
            h = _shared_block(cfg, params["shared_block"], h, h0, positions)
    return _run_layers(cfg, "mamba", seg, groups * period, cfg.n_layers, h,
                       positions, aux)


def hidden_states(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  prefix_embeddings: Optional[torch.Tensor] = None,
                  enc_out: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Final-normed hidden states (B, S, d_model) and the auxiliary loss
    summed over the layers (fp32; 0 without MoE layers) of int ``tokens``
    (B, S), the hidden states in ``cfg.adtype``."""
    if prefix_embeddings is not None or enc_out is not None:
        raise NotImplementedError(
            "prefix embeddings and encoder outputs are not ported yet "
            "(ROADMAP A15.7)")
    h = layers.embed(params["embed"], tokens).to(cfg.adtype)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if _hybrid(cfg):
        h, aux = _hybrid_stack(cfg, params, h, positions, aux)
    else:
        for i, (kind, count) in enumerate(cfg.segments()):
            h, aux = _run_layers(cfg, kind, params[f"seg{i}"], 0, count, h,
                                 positions, aux)
    return _norm(cfg, params["final_norm"], h), aux


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], h)
    else:
        logits = layers.dense(params["head"], h)
    return logits.to(torch.float32)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embeddings: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward: (logits (B, S, V) fp32, auxiliary loss)."""
    h, aux = hidden_states(params, cfg, tokens, prefix_embeddings, enc_out)
    return logits_from_hidden(params, cfg, h), aux


def mtp_logits(params: Params, cfg: ModelConfig, h: torch.Tensor,
               next_tokens: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction head (depth 1): logits (B, S,
    V) fp32 for token t+2 from the trunk's final-normed hidden state ``h``
    (B, S, D) at t and the embedding of ``next_tokens`` (B, S), token
    t+1."""
    p = params["mtp"]
    emb = layers.embed(params["embed"], next_tokens).to(h.dtype)
    x = layers.dense(p["proj"], torch.cat(
        [_norm(cfg, p["norm_h"], h), _norm(cfg, p["norm_e"], emb)], dim=-1))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x = _dense_layer(cfg, p["block"], x, positions)
    return logits_from_hidden(params, cfg, _norm(cfg, p["final_norm"], x))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _stacked(one: Any, count: int) -> Any:
    return tree_map(lambda x: x.expand((count,) + tuple(x.shape)).clone(),
                    one)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Per-segment caches stacked on a leading layer axis: ``seg{i}`` (an
    ``SSMCache`` for a mamba run, else a ``KVCache`` of ``max_len`` slots,
    or of the window's under a sliding window), ``shared`` (the hybrid's
    shared block, one KV cache per application) and ``pos``, the absolute
    position shared by every layer.  Every cache in ``dtype``, bf16 by
    default as in the reference, but the SSM states, which are fp32."""
    caches: dict = {}
    for i, (kind, count) in enumerate(cfg.segments()):
        if kind == "mamba":
            one = ssm_lib.ssm_cache_init(batch, cfg.ssm, dtype, device)
        else:
            window = cfg.attn_window
            cache_len = min(max_len, window) if window else max_len
            one = attn_lib.kv_cache_init(batch, cache_len, cfg.n_kv_heads,
                                         cfg.head_dim_, dtype, device)
        caches[f"seg{i}"] = _stacked(one, count)
    if _hybrid(cfg):
        caches["shared"] = _stacked(
            attn_lib.kv_cache_init(batch, max_len, cfg.n_kv_heads,
                                   cfg.head_dim_, dtype, device),
            cfg.n_layers // cfg.shared_attn_period)
    caches["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return caches


def _layer_decode(cfg: ModelConfig, kind: str, p: Params, h: torch.Tensor,
                  cache) -> tuple[torch.Tensor, Any]:
    if kind == "mamba":
        out, new_cache = ssm_lib.mamba2_decode_step(
            p["mixer"], _norm(cfg, p["norm"], h), cache, cfg.ssm)
        return h + out, new_cache
    out, new_cache = _attn_decode(cfg, p["attn"], _norm(cfg, p["norm1"], h),
                                  cache, cfg.attn_window)
    h = h + out
    if kind == "moe":
        out, _ = moe_lib.moe_apply(p["moe"], _norm(cfg, p["norm2"], h),
                                   _moe_cfg(cfg))
        return h + out, new_cache
    return h + _mlp(cfg, p["mlp"], _norm(cfg, p["norm2"], h)), new_cache


def _decode_layers(cfg: ModelConfig, kind: str, seg: Params, cache,
                   lo: int, hi: int, h: torch.Tensor):
    """Layers ``lo`` to ``hi`` of a segment: (h, their new caches)."""
    new = []
    for j in range(lo, hi):
        h, c = _layer_decode(cfg, kind, _layer(seg, j), h, _layer(cache, j))
        new.append(c)
    return h, new


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, enc_out: Optional[torch.Tensor] = None):
    """One-token decode.  tokens (B, 1) -> (logits (B, 1, V) fp32, the new
    cache); ``cache`` is left as it was."""
    if enc_out is not None:
        raise NotImplementedError(
            "the cross-attention input is not ported yet (ROADMAP A15.7)")
    h = layers.embed(params["embed"], tokens).to(cfg.adtype)
    new_caches = dict(cache)
    stack = lambda cs: tree_map(lambda *xs: torch.stack(xs), *cs)
    if _hybrid(cfg):
        h0 = h
        period, seg = cfg.shared_attn_period, params["seg0"]
        groups = cfg.n_layers // period
        sb = params["shared_block"]
        mamba_caches, shared_caches = [], []
        for gi in range(groups):
            h, new = _decode_layers(cfg, "mamba", seg, cache["seg0"],
                                    gi * period, (gi + 1) * period, h)
            mamba_caches += new
            x = layers.dense(sb["in_proj"], torch.cat([h, h0], dim=-1))
            out, sc = _attn_decode(cfg, sb["attn"], _norm(cfg, sb["norm1"], x),
                                   _layer(cache["shared"], gi), None)
            x = x + out
            x = x + _mlp(cfg, sb["mlp"], _norm(cfg, sb["norm2"], x))
            h = h + x
            shared_caches.append(sc)
        h, new = _decode_layers(cfg, "mamba", seg, cache["seg0"],
                                groups * period, cfg.n_layers, h)
        new_caches["seg0"] = stack(mamba_caches + new)
        new_caches["shared"] = stack(shared_caches)
    else:
        for i, (kind, count) in enumerate(cfg.segments()):
            h, new = _decode_layers(cfg, kind, params[f"seg{i}"],
                                    cache[f"seg{i}"], 0, count, h)
            new_caches[f"seg{i}"] = stack(new)
    new_caches["pos"] = cache["pos"] + tokens.shape[1]
    h = _norm(cfg, params["final_norm"], h)
    return logits_from_hidden(params, cfg, h), new_caches
