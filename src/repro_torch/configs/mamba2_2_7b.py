"""mamba2-2.7b [ssm] — arXiv:2405.21060 (SSD / state-space duality).

64L d_model=2560, attention-free, d_ff=0, vocab=50280, ssm_state=128,
head_dim=64, expand=2.  The reference's config unchanged, bf16 parameters
and activations included, and the port builds it so (``dt_bias``,
``A_log`` and ``D`` stay fp32, as in the reference).
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import SSMConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280, attn_type="none",
        ssm=SSMConfig(d_model=2560, d_state=128, head_dim=64, expand=2,
                      d_conv=4, chunk=256),
        norm="rms", tie_embeddings=True,
        param_dtype="bfloat16", activation_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelConfig:
    return base.reduce_for_smoke(full())


base.register("mamba2-2.7b", full, smoke)
