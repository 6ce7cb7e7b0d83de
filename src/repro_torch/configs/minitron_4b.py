"""minitron-4b [dense] — arXiv:2407.14679 (pruned Nemotron-4 15B).

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000, head_dim=128.
Nemotron uses squared-ReLU MLPs; the reference keeps its SwiGLU MLP at
the same d_ff, and so does the port.  bf16 parameters and activations as
published, and the port builds it so.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=9216, vocab_size=256000, head_dim=128,
        rope_theta=10000.0, norm="rms", act="swiglu", tie_embeddings=True,
        param_dtype="bfloat16", activation_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelConfig:
    return base.reduce_for_smoke(full())


base.register("minitron-4b", full, smoke)
