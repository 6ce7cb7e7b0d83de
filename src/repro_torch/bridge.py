"""Convert parameters between the JAX reference and the port.

The port keeps the reference's pytree keys and layouts (conv weights HWIO,
dense weights ``(in, out)``, stacked leaves ``(K, ...)``), so the bridge is
a structural copy: numpy arrays in, tensors out, and back, each leaf in
its own dtype (a bf16 model's MoE routers stay fp32; the experts' (E, D,
F) and (E, F, D) weights, the shared expert and the MTP head keep their
keys and layouts).  The tests load the reference's initialisation this
way, since torch cannot replay ``jax.random``.

bfloat16 leaves go through their 16 bits both ways: ``np.asarray`` of a
JAX bf16 array has numpy's ``bfloat16`` extension type (``ml_dtypes``),
which ``torch.from_numpy`` refuses, and a bf16 tensor has no ``.numpy()``.
The type is recognised by its name, so the bridge imports nothing of
``ml_dtypes`` (the card's host need not have it).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def array_to_tensor(a: Any) -> torch.Tensor:
    """A numpy (or array-like) leaf as a CPU tensor of its own; a bfloat16
    array as a ``torch.bfloat16`` tensor of the same bits."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy copy; a bf16 tensor as numpy's ``bfloat16``
    (the type JAX reads) when the numpy in this process knows it, else as
    float32, which holds every bf16 value exactly."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    bits = t.view(torch.int16).numpy().copy()
    try:
        return bits.view(np.dtype("bfloat16"))
    except TypeError:
        return t.to(torch.float32).numpy()


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``."""
    return tree_map(lambda a: array_to_tensor(a).to(device), tree)


def params_to_numpy(params: Any) -> Any:
    """Nested dict of tensors -> the same dict of numpy arrays (host copies)."""
    return tree_map(tensor_to_array, params)
