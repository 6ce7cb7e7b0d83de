"""zamba2-1.2b [hybrid] — arXiv:2411.15242.

38 Mamba2 layers (d_model=2048, ssm_state=64) + a SHARED attention+MLP block
(32H, kv=32, d_ff=8192) applied every 6 Mamba layers, consuming
[h ; embedding-stream] (the Zamba re-injection trick).  bf16 parameters
and activations as published, and the port builds it so.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import SSMConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32000, head_dim=64,
        ssm=SSMConfig(d_model=2048, d_state=64, head_dim=64, expand=2,
                      d_conv=4, chunk=256),
        shared_attn_period=6,
        norm="rms", act="swiglu", tie_embeddings=True,
        param_dtype="bfloat16", activation_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelConfig:
    return base.reduce_for_smoke(full())


base.register("zamba2-1.2b", full, smoke)
