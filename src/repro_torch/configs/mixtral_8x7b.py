"""mixtral-8x7b [moe] — arXiv:2401.04088.

32L d_model=4096 32H (GQA kv=8) d_ff=14336/expert, vocab=32000,
8 experts top-2, sliding-window attention (4096).  Softmax-over-top-k
gates.  The reference's config unchanged, bf16 parameters and activations
included (the router is fp32 in any dtype), and the port builds it so.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=32000, head_dim=128,
        attn_window=4096, rope_theta=1e6,
        moe=MoEConfig(d_model=4096, d_ff=14336, n_experts=8, top_k=2,
                      router_type="softmax"),
        norm="rms", act="swiglu", tie_embeddings=False,
        param_dtype="bfloat16", activation_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelConfig:
    return base.reduce_for_smoke(full())


base.register("mixtral-8x7b", full, smoke)
