"""Architecture configs: the registry and the paper's own tasks.

``get_config(name)`` returns the published ModelConfig and
``get_smoke_config(name)`` the reduced same-family variant of the CPU
tests; only ``mamba2-2.7b`` is ported (the others raise, naming ROADMAP
A15).  ``configs.paper`` holds the paper's tasks.
"""
from repro_torch.configs.base import (  # noqa: F401
    ALL_ARCHS, SHAPES, InputShape, get_config, get_smoke_config, list_archs,
    register,
)

# imported for its registration
from repro_torch.configs import mamba2_2_7b  # noqa: F401,E402
