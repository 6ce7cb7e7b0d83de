"""llava-next-34b [vlm] — hf:llava-hf/llava-v1.6 (34B = Yi-34B backbone).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  AnyRes tiling:
the SigLIP/CLIP tower and its projector are stubs, so the backbone takes
precomputed patch embeddings (576 base patches) before the text tokens;
the labels are the text's only (no loss at the frontend positions).  The
reference's config unchanged, bf16 included.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab_size=64000, head_dim=128, rope_theta=5e6,
        frontend="vision",
        norm="rms", act="swiglu", tie_embeddings=False,
        param_dtype="bfloat16", activation_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelConfig:
    return base.reduce_for_smoke(full())


base.register("llava-next-34b", full, smoke)
