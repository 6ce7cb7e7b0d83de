"""phi4-mini-3.8b [dense] — arXiv:2412.08905.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064. RoPE + SwiGLU + GQA.
``long_variant()`` is the reference's long-context demonstration: a 4k
sliding window, which the decode path keeps as a ring buffer.  The
reference's config unchanged, bf16 parameters and activations included,
and the port builds it so.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab_size=200064, head_dim=128,
        norm="rms", act="swiglu", tie_embeddings=True,
        param_dtype="bfloat16", activation_dtype="bfloat16", remat=True,
    )


def long_variant() -> ModelConfig:
    return full().replace(attn_window=4096)


def smoke() -> ModelConfig:
    return base.reduce_for_smoke(full())


base.register("phi4-mini-3.8b", full, smoke)
