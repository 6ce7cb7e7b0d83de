"""internlm2-20b [dense] — arXiv:2403.17297.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544, an untied LM head,
RoPE theta 1e6.  bf16 parameters and activations as published, and the
port builds it so.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=92544, head_dim=128, rope_theta=1e6,
        norm="rms", act="swiglu", tie_embeddings=False,
        param_dtype="bfloat16", activation_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelConfig:
    return base.reduce_for_smoke(full())


base.register("internlm2-20b", full, smoke)
