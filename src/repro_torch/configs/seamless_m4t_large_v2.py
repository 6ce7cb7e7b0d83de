"""seamless-m4t-large-v2 [audio, enc-dec] — arXiv:2308.11596.

24L d_model=1024 16H (GQA kv=16 == MHA) d_ff=8192 vocab=256206.
Backbone only: the w2v-BERT speech codec is a stub, so the encoder takes
precomputed frame embeddings (``frontends.AUDIO_FRAMES`` a clip).  24
encoder layers + 24 text-decoder layers (the model card's geometry).
LayerNorm + GELU as in the original transformer stack; RoPE in place of
the sinusoidal positions, as in the reference.  The reference's config
unchanged, bf16 included.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab_size=256206, head_dim=64,
        enc_layers=24, frontend="audio",
        norm="ln", act="gelu", tie_embeddings=True,
        param_dtype="bfloat16", activation_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelConfig:
    return base.reduce_for_smoke(full())


base.register("seamless-m4t-large-v2", full, smoke)
