"""Architecture configs: the registry and the paper's own tasks.

``get_config(name)`` returns the published ModelConfig and
``get_smoke_config(name)`` the reduced same-family variant of the CPU
tests, for every name of ``ALL_ARCHS``: phi4-mini-3.8b, minitron-4b,
granite-34b, internlm2-20b (dense), mixtral-8x7b and deepseek-v3-671b
(MoE; deepseek with MLA), mamba2-2.7b (SSM), zamba2-1.2b (hybrid),
seamless-m4t-large-v2 (audio encoder-decoder) and llava-next-34b (VLM).
``configs.paper`` holds the paper's tasks.
"""
from repro_torch.configs.base import (  # noqa: F401
    ALL_ARCHS, SHAPES, InputShape, decode_input_specs, get_config,
    get_smoke_config, input_specs, list_archs, register, train_input_specs,
)

# imported for their registration
from repro_torch.configs import (  # noqa: F401,E402
    deepseek_v3_671b, granite_34b, internlm2_20b, llava_next_34b,
    mamba2_2_7b, minitron_4b, mixtral_8x7b, phi4_mini_3_8b,
    seamless_m4t_large_v2, zamba2_1_2b,
)
