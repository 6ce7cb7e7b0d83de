"""Architecture configs: the registry and the paper's own tasks.

``get_config(name)`` returns the published ModelConfig and
``get_smoke_config(name)`` the reduced same-family variant of the CPU
tests.  Ported: phi4-mini-3.8b, minitron-4b, granite-34b, internlm2-20b
(dense), mixtral-8x7b (MoE), mamba2-2.7b (SSM) and zamba2-1.2b (hybrid);
the other names of ``ALL_ARCHS`` raise, naming ROADMAP A15.6-A15.7.
``configs.paper`` holds the paper's tasks.
"""
from repro_torch.configs.base import (  # noqa: F401
    ALL_ARCHS, SHAPES, InputShape, get_config, get_smoke_config, list_archs,
    register,
)

# imported for their registration
from repro_torch.configs import (  # noqa: F401,E402
    granite_34b, internlm2_20b, mamba2_2_7b, minitron_4b, mixtral_8x7b,
    phi4_mini_3_8b, zamba2_1_2b,
)
