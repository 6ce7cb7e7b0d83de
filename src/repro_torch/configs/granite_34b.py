"""granite-34b [dense, code] — arXiv:2405.04324 (Granite Code 34B).

88L d_model=6144 48H (MQA: kv=1) d_ff=24576 vocab=49152.
GPTBigCode-style: LayerNorm + GELU, multi-query attention, biased q/k/v.
The original uses learned absolute positions; the reference uses RoPE,
and so does the port.  bf16 parameters and activations as published, and
the port builds it so.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab_size=49152, head_dim=128,
        norm="ln", act="gelu", qkv_bias=True, tie_embeddings=True,
        param_dtype="bfloat16", activation_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelConfig:
    return base.reduce_for_smoke(full())


base.register("granite-34b", full, smoke)
