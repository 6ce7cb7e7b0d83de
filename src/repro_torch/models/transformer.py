"""The model stack over plain-dict params: every family of the reference.

The port of ``repro.models.transformer``: token embedding (after a prefix
of frontend embeddings where the caller gives one), the layer runs that
``ModelConfig.segments()`` yields (pre-norm blocks of causal GQA or MLA
attention and a GELU or SwiGLU MLP, the same with a mixture of experts in
place of the MLP (``models.moe``), or pre-norm residual Mamba-2 blocks),
for the
hybrid (Zamba2) one shared attention + MLP block applied after every
``shared_attn_period`` Mamba-2 layers to ``[h ; h0]`` projected back to
d_model (h0 the embedding stream), the final norm, and the logits (the
tied unembedding or an untied ``head``).  Parameters keep the reference's
keys and layouts, the per-layer leaves stacked on a leading layer axis
under ``seg{i}`` (the reference stacks them for ``lax.scan``; the port
unbinds that axis once a forward or decode step and loops over the
layers).  ``cfg.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``), the counterpart of the reference's
per-layer ``jax.checkpoint``.  ``hidden_states`` and ``forward`` return
the MoE layers' load-balance losses summed over every layer (0 without
MoE layers).  ``mtp_logits`` is DeepSeek-V3's multi-token prediction head
(``mtp_depth``), which predicts token t+2 from the trunk's hidden state at
t and the embedding of token t+1.

Encoder-decoder models (``cfg.enc_layers``): ``encode`` runs a stack of
pre-norm encoder layers with bidirectional self-attention over frontend
embeddings (normed first, ``enc_embed_norm``; ``enc_final_norm`` after),
and each decoder layer of the dense run adds cross-attention to the
encoder's output (``xattn``, normed by ``norm_x``) between its causal
self-attention and its MLP.  Frontend models take their embeddings as a
prefix of the decoder's input (``prefix_embeddings``).  A run of no
layers (deepseek-v3 cut to ``first_k_dense`` layers leaves a MoE run of
0) has leaves with a leading axis of 0, as the reference's stack has, and
is skipped.

Every attention of a forward goes through ``kernels.flash_attention.ops.
flash_attention_gqa`` and every SSD scan through ``kernels.ssd_scan.ops.
ssd_scan``: the CUDA kernel on a card, its plain version on the CPU.  In
the reference ``cfg.use_pallas`` picks between the Pallas kernel and the
jnp function; here the device picks, as it does for the port's other
kernels, and the tests hold the two to the same function.  That holds for
the encoder's bidirectional attention and for cross-attention (queries of
the decoder against the encoder's keys, Sq != Skv), which the kernel runs
non-causal.  MLA is the exception: the reference computes it in einsums
outside any Pallas kernel, and so does the port (``models.attention``).

Decode (``init_cache``, ``decode_step``) carries a KV cache per attention
layer (a ring buffer under a sliding window; MLA's compressed latent and
RoPE key), one per application of the
hybrid's shared block, and a conv and SSM state per Mamba-2 layer; one
token's step is plain PyTorch, as in the reference, which computes it
outside any Pallas kernel.  A MoE layer's decode dispatches the B tokens
of the step as one group under the reference's capacity rule, so a token
is dropped where the reference drops it.  An encoder-decoder's decode
takes the encoder's output and recomputes the cross-attention's keys and
values from it at every step, as the reference does (no cross cache).
The caches default to bf16, as the reference's do.

Parameters are built in ``cfg.pdtype``, the embedding is cast to
``cfg.adtype`` and the logits to fp32, as in the reference; the layers
round where the reference's round (``models.layers``).  The logit soft
cap waits for a config that sets it.
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
from repro_torch.tree import tree_flatten, tree_map


def _norm_init(cfg: ModelConfig, d: int,
               generator: Optional[torch.Generator]) -> Params:
    device = layers.const_device(generator)
    return layers.rmsnorm_init(d, cfg.pdtype, device) if cfg.norm == "rms" \
        else layers.layernorm_init(d, cfg.pdtype, device)


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
    if cfg.attn_type == "mla":
        return attn_lib.mla_init(generator, cfg.mla, cfg.pdtype)
    return attn_lib.gqa_init(generator, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim_, cfg.qkv_bias,
                             cfg.pdtype)


def _attn_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    if cfg.attn_type == "mla":
        return attn_lib.mla_attention(p, x, cfg.mla, positions)
    return attn_lib.gqa_attention(
        p, x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, positions=positions, window=window,
        rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)


def _attn_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 cache, window: Optional[int]):
    if cfg.attn_type == "mla":
        return attn_lib.mla_decode_step(p, x, cache, cfg.mla)
    return attn_lib.gqa_decode_step(
        p, x, cache, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, window=window, rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope)


def _dense_layer_init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return {"norm1": _norm_init(cfg, cfg.d_model, generator),
            "attn": _attn_init(cfg, generator),
            "norm2": _norm_init(cfg, cfg.d_model, generator),
            "mlp": _mlp_init(cfg, generator, cfg.d_ff)}


def _dense_layer(cfg: ModelConfig, p: Params, h: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = h + _attn_apply(cfg, p["attn"], _norm(cfg, p["norm1"], h), positions,
                        cfg.attn_window)
    return h + _mlp(cfg, p["mlp"], _norm(cfg, p["norm2"], h))


def _moe_cfg(cfg: ModelConfig) -> moe_lib.MoEConfig:
    return cfg.moe._replace(group_size=cfg.moe_group_size)


def _moe_layer_init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return {"norm1": _norm_init(cfg, cfg.d_model, generator),
            "attn": _attn_init(cfg, generator),
            "norm2": _norm_init(cfg, cfg.d_model, generator),
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
    return {"norm": _norm_init(cfg, cfg.d_model, generator),
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
            "norm1": _norm_init(cfg, cfg.d_model, generator),
            "attn": _attn_init(cfg, generator),
            "norm2": _norm_init(cfg, cfg.d_model, generator),
            "mlp": _mlp_init(cfg, generator, cfg.d_ff)}


def _shared_block(cfg: ModelConfig, p: Params, h: torch.Tensor,
                  h0: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    x = layers.dense(p["in_proj"], torch.cat([h, h0], dim=-1))
    x = x + _attn_apply(cfg, p["attn"], _norm(cfg, p["norm1"], x), positions,
                        None)
    x = x + _mlp(cfg, p["mlp"], _norm(cfg, p["norm2"], x))
    return h + x


# ---------------------------------------------------------------------------
# the encoder (encoder-decoder models) and the cross-attention decoder layer
# ---------------------------------------------------------------------------

def _enc_layer(cfg: ModelConfig, p: Params, h: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """A pre-norm encoder layer: bidirectional self-attention (no mask),
    then the MLP."""
    b, s, _ = h.shape
    x = _norm(cfg, p["norm1"], h)
    q, k, v = attn_lib.gqa_project_qkv(p["attn"], x, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.head_dim_,
                                       positions, cfg.rope_theta,
                                       cfg.use_rope)
    out = attn_lib.flash_attention_gqa(q, k, v, causal=False)
    h = h + layers.dense(p["attn"]["wo"], out.reshape(b, s, -1))
    return h + _mlp(cfg, p["mlp"], _norm(cfg, p["norm2"], h))


def _xattn_layer_init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    p = _dense_layer_init(cfg, generator)
    p["norm_x"] = _norm_init(cfg, cfg.d_model, generator)
    p["xattn"] = attn_lib.gqa_init(generator, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim_, False,
                                   cfg.pdtype)
    return p


def _cross_attend(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  enc_out: torch.Tensor) -> torch.Tensor:
    """The decoder's queries (B, S, ...) against keys and values made from
    the encoder's output (B, S_enc, ...), no RoPE and no mask."""
    b, s, _ = x.shape
    se, hd = enc_out.shape[1], cfg.head_dim_
    q = layers.dense(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = layers.dense(p["wk"], enc_out).reshape(b, se, cfg.n_kv_heads, hd)
    v = layers.dense(p["wv"], enc_out).reshape(b, se, cfg.n_kv_heads, hd)
    out = attn_lib.flash_attention_gqa(q, k, v, causal=False)
    return layers.dense(p["wo"], out.reshape(b, s, cfg.n_heads * hd))


def _xattn_layer(cfg: ModelConfig, p: Params, h: torch.Tensor,
                 positions: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    h = h + _attn_apply(cfg, p["attn"], _norm(cfg, p["norm1"], h), positions,
                        None)
    h = h + _cross_attend(cfg, p["xattn"], _norm(cfg, p["norm_x"], h),
                          enc_out)
    return h + _mlp(cfg, p["mlp"], _norm(cfg, p["norm2"], h))


def _stack_init(fn, cfg: ModelConfig, generator: torch.Generator,
                count: int) -> Params:
    """``count`` layers of ``fn`` with their leaves stacked on a leading
    axis.  A run of no layers draws nothing: its leaves have the layer's
    shapes after a leading 0, as the reference's ``vmap`` over no keys
    gives them."""
    if count == 0:
        return tree_map(lambda x: torch.empty(
            (0,) + tuple(x.shape), dtype=x.dtype,
            device=generator.device if generator is not None else "meta"),
            fn(cfg, None))
    per_layer = [fn(cfg, generator) for _ in range(count)]
    return tree_map(lambda *xs: torch.stack(xs), *per_layer)


def init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Parameters: ``embed``, ``final_norm``, ``seg{i}`` (each leaf with a
    leading axis of the segment's layer count, 0 for an empty run), and
    ``head`` (untied), ``shared_block`` (hybrid), ``enc_embed_norm``,
    ``enc`` (the encoder's stacked layers) and ``enc_final_norm``
    (encoder-decoder) and ``mtp`` (``proj``, ``norm_h``, ``norm_e``, a
    dense ``block`` and ``final_norm``) where the config has them.  The
    weights are drawn on ``generator``'s device, the norms made on the CPU;
    every leaf is ``cfg.pdtype`` but the Mamba-2 layers' ``dt_bias``,
    ``A_log`` and ``D`` and the MoE routers, which are fp32.  With
    ``generator=None`` every leaf is a meta tensor of its shape and dtype,
    holding no data and drawing nothing (the dry-run's parameters)."""
    params: Params = {
        "embed": layers.embedding_init(generator, cfg.vocab_size, cfg.d_model,
                                       cfg.pdtype),
        "final_norm": _norm_init(cfg, cfg.d_model, generator),
    }
    if not cfg.tie_embeddings:
        params["head"] = layers.dense_init(generator, cfg.d_model,
                                           cfg.vocab_size, cfg.pdtype)
    for i, (kind, count) in enumerate(cfg.segments()):
        # an encoder-decoder's dense run is its decoder, with cross-attention
        fn = (_xattn_layer_init if cfg.enc_layers and kind == "dense"
              else _LAYER_INIT[kind])
        params[f"seg{i}"] = _stack_init(fn, cfg, generator, count)
    if _hybrid(cfg):
        params["shared_block"] = _shared_block_init(cfg, generator)
    if cfg.enc_layers:
        params["enc_embed_norm"] = _norm_init(cfg, cfg.d_model, generator)
        params["enc"] = _stack_init(_dense_layer_init, cfg, generator,
                                    cfg.enc_layers)
        params["enc_final_norm"] = _norm_init(cfg, cfg.d_model, generator)
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": layers.dense_init(generator, 2 * cfg.d_model, cfg.d_model,
                                      cfg.pdtype),
            "norm_h": _norm_init(cfg, cfg.d_model, generator),
            "norm_e": _norm_init(cfg, cfg.d_model, generator),
            "block": _dense_layer_init(cfg, generator),
            "final_norm": _norm_init(cfg, cfg.d_model, generator),
        }
    return params


def _unstack(tree: Any, count: int) -> list:
    """The ``count`` per-layer trees of a stacked segment, from one
    ``torch.unbind`` a leaf.  Its backward stacks the layers' gradients
    once, where an index a layer (``x[j]``) would scatter each into a zero
    tensor the size of the whole stack and sum them: O(L²) in the depth."""
    leaves, rebuild = tree_flatten(tree)
    per_leaf = [torch.unbind(x) for x in leaves]
    return [rebuild([u[j] for u in per_leaf]) for j in range(count)]


def _run_layers(cfg: ModelConfig, kind: str, layer_params: list,
                h: torch.Tensor, positions: torch.Tensor, aux: torch.Tensor,
                enc_out: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The layers ``layer_params`` (``_unstack``) in turn: (h, ``aux``
    plus their load-balance losses where they are MoE layers).  An
    encoder-decoder's dense layers attend to ``enc_out`` too."""
    apply, extra = _LAYER_APPLY[kind], ()
    if cfg.enc_layers and kind == "dense":
        apply, extra = _xattn_layer, (enc_out,)
    for p in layer_params:
        if cfg.remat and torch.is_grad_enabled():
            out = checkpoint(apply, cfg, p, h, positions, *extra,
                             use_reentrant=False)
        else:
            out = apply(cfg, p, h, positions, *extra)
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
    period = cfg.shared_attn_period
    seg = _unstack(params["seg0"], cfg.n_layers)
    groups = cfg.n_layers // period
    h0 = h
    for gi in range(groups):
        h, aux = _run_layers(cfg, "mamba", seg[gi * period:(gi + 1) * period],
                             h, positions, aux)
        if cfg.remat and torch.is_grad_enabled():
            h = checkpoint(_shared_block, cfg, params["shared_block"], h, h0,
                           positions, use_reentrant=False)
        else:
            h = _shared_block(cfg, params["shared_block"], h, h0, positions)
    return _run_layers(cfg, "mamba", seg[groups * period:], h, positions,
                       aux)


def encode(params: Params, cfg: ModelConfig,
           enc_embeddings: torch.Tensor) -> torch.Tensor:
    """The encoder of an encoder-decoder: frontend embeddings (B, S_enc,
    d_model), normed in ``cfg.adtype``, through the bidirectional encoder
    layers, final-normed: (B, S_enc, d_model)."""
    h = _norm(cfg, params["enc_embed_norm"], enc_embeddings.to(cfg.adtype))
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    for p in _unstack(params["enc"], cfg.enc_layers):
        if cfg.remat and torch.is_grad_enabled():
            h = checkpoint(_enc_layer, cfg, p, h, positions,
                           use_reentrant=False)
        else:
            h = _enc_layer(cfg, p, h, positions)
    return _norm(cfg, params["enc_final_norm"], h)


def _embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  prefix_embeddings: Optional[torch.Tensor]) -> torch.Tensor:
    h = layers.embed(params["embed"], tokens).to(cfg.adtype)
    if prefix_embeddings is not None:
        h = torch.cat([prefix_embeddings.to(cfg.adtype), h], dim=1)
    return h


def hidden_states(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  prefix_embeddings: Optional[torch.Tensor] = None,
                  enc_out: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Final-normed hidden states (B, S, d_model) and the auxiliary loss
    summed over the layers (fp32; 0 without MoE layers) of int ``tokens``
    (B, S_text) after ``prefix_embeddings`` (B, S_prefix, d_model) where
    given (S = S_prefix + S_text), the hidden states in ``cfg.adtype``.
    An encoder-decoder's decoder attends to ``enc_out`` (``encode``)."""
    h = _embed_inputs(params, cfg, tokens, prefix_embeddings)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if _hybrid(cfg):
        h, aux = _hybrid_stack(cfg, params, h, positions, aux)
    else:
        for i, (kind, count) in enumerate(cfg.segments()):
            h, aux = _run_layers(cfg, kind, _unstack(params[f"seg{i}"], count),
                                 h, positions, aux, enc_out)
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
    """Full forward: (logits (B, S_prefix + S_text, V) fp32, auxiliary
    loss)."""
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
    ``SSMCache`` for a mamba run, an ``MLACache`` under MLA, else a
    ``KVCache`` of ``max_len`` slots, or of the window's under a sliding
    window), ``shared`` (the hybrid's
    shared block, one KV cache per application) and ``pos``, the absolute
    position shared by every layer.  Every cache in ``dtype``, bf16 by
    default as in the reference, but the SSM states, which are fp32."""
    caches: dict = {}
    for i, (kind, count) in enumerate(cfg.segments()):
        if kind == "mamba":
            one = ssm_lib.ssm_cache_init(batch, cfg.ssm, dtype, device)
        elif cfg.attn_type == "mla":
            one = attn_lib.mla_cache_init(batch, max_len, cfg.mla, dtype,
                                          device)
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
                  cache, enc_out: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, Any]:
    if kind == "mamba":
        out, new_cache = ssm_lib.mamba2_decode_step(
            p["mixer"], _norm(cfg, p["norm"], h), cache, cfg.ssm)
        return h + out, new_cache
    out, new_cache = _attn_decode(cfg, p["attn"], _norm(cfg, p["norm1"], h),
                                  cache, cfg.attn_window)
    h = h + out
    if cfg.enc_layers:
        h = h + _cross_attend(cfg, p["xattn"], _norm(cfg, p["norm_x"], h),
                              enc_out)
    if kind == "moe":
        out, _ = moe_lib.moe_apply(p["moe"], _norm(cfg, p["norm2"], h),
                                   _moe_cfg(cfg))
        return h + out, new_cache
    return h + _mlp(cfg, p["mlp"], _norm(cfg, p["norm2"], h)), new_cache


def _decode_layers(cfg: ModelConfig, kind: str, layer_params: list,
                   layer_caches: list, h: torch.Tensor,
                   enc_out: Optional[torch.Tensor] = None):
    """The layers ``layer_params`` with their caches (``_unstack``) in
    turn: (h, their new caches)."""
    new = []
    for p, c in zip(layer_params, layer_caches, strict=True):
        h, c = _layer_decode(cfg, kind, p, h, c, enc_out)
        new.append(c)
    return h, new


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, enc_out: Optional[torch.Tensor] = None):
    """One-token decode.  tokens (B, 1) -> (logits (B, 1, V) fp32, the new
    cache); ``cache`` is left as it was.  An encoder-decoder's decoder
    attends to ``enc_out`` (``encode``'s output) at every step."""
    h = layers.embed(params["embed"], tokens).to(cfg.adtype)
    new_caches = dict(cache)
    stack = lambda cs: tree_map(lambda *xs: torch.stack(xs), *cs)
    if _hybrid(cfg):
        h0 = h
        period = cfg.shared_attn_period
        groups = cfg.n_layers // period
        seg = _unstack(params["seg0"], cfg.n_layers)
        seg_caches = _unstack(cache["seg0"], cfg.n_layers)
        sb = params["shared_block"]
        mamba_caches, shared_caches = [], []
        for gi, shared in enumerate(_unstack(cache["shared"], groups)):
            lo, hi = gi * period, (gi + 1) * period
            h, new = _decode_layers(cfg, "mamba", seg[lo:hi],
                                    seg_caches[lo:hi], h)
            mamba_caches += new
            x = layers.dense(sb["in_proj"], torch.cat([h, h0], dim=-1))
            out, sc = _attn_decode(cfg, sb["attn"], _norm(cfg, sb["norm1"], x),
                                   shared, None)
            x = x + out
            x = x + _mlp(cfg, sb["mlp"], _norm(cfg, sb["norm2"], x))
            h = h + x
            shared_caches.append(sc)
        h, new = _decode_layers(cfg, "mamba", seg[groups * period:],
                                seg_caches[groups * period:], h)
        new_caches["seg0"] = stack(mamba_caches + new)
        new_caches["shared"] = stack(shared_caches)
    else:
        for i, (kind, count) in enumerate(cfg.segments()):
            if count == 0:               # an empty run: its cache as it was
                continue
            h, new = _decode_layers(cfg, kind,
                                    _unstack(params[f"seg{i}"], count),
                                    _unstack(cache[f"seg{i}"], count), h,
                                    enc_out)
            new_caches[f"seg{i}"] = stack(new)
    new_caches["pos"] = cache["pos"] + tokens.shape[1]
    h = _norm(cfg, params["final_norm"], h)
    return logits_from_hidden(params, cfg, h), new_caches
