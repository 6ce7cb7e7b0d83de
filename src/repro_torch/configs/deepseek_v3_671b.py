"""deepseek-v3-671b [moe] — arXiv:2412.19437.

61L d_model=7168, MLA with 128 heads (nope 128 + rope 64, v 128;
q_lora 1536, kv_lora 512), MoE: 1 shared + 256 routed experts top-8
(sigmoid router, per-expert d_ff=2048), first 3 layers dense (d_ff=18432),
vocab=129280, MTP depth 1.  The reference's config unchanged, bf16
parameters and activations included (the routers are fp32 in any dtype).
"""
from repro_torch.configs import base
from repro_torch.models.attention import MLAConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432,  # dense-layer d_ff (first_k_dense)
        vocab_size=129280,
        attn_type="mla",
        mla=MLAConfig(d_model=7168, n_heads=128, q_lora_rank=1536,
                      kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(d_model=7168, d_ff=2048, n_experts=256, top_k=8,
                      n_shared_experts=1, shared_d_ff=2048,
                      router_type="sigmoid", capacity_factor=1.25),
        first_k_dense=3, mtp_depth=1,
        norm="rms", act="swiglu", tie_embeddings=False,
        param_dtype="bfloat16", activation_dtype="bfloat16", remat=True,
        moe_group_size=4096,
    )


def smoke() -> ModelConfig:
    return base.reduce_for_smoke(full())


base.register("deepseek-v3-671b", full, smoke)
