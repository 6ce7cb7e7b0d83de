"""Convert parameters between the JAX reference and the port.

The port keeps the reference's pytree keys and layouts (conv weights HWIO,
dense weights ``(in, out)``, stacked leaves ``(K, ...)``), so the bridge is
a structural copy: numpy arrays in, tensors out, and back.  The tests load
the reference's initialisation this way, since torch cannot replay
``jax.random``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True))
                    .to(device), tree)


def params_to_numpy(params: Any) -> Any:
    """Nested dict of tensors -> the same dict of numpy arrays (host copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), params)
