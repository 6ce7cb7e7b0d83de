"""Mid-run crash recovery: the full federated run state <-> disk.

The port of ``repro.checkpoint.recovery``.  Resuming a killed run bit for
bit needs more than the parameters: the numpy sampler's state, the FedGKD
``ModelBuffer`` (models and version counter), the fault injector's
stream, per-client algorithm state, the round records and, for the async
loop, the simulator's event heap with its in-flight uploads.  Those are no
fixed-structure pytree, so each ``state_NNNNNN.npz`` describes itself:
every array is stored flat under a generated key, and the ``.meta`` sidecar
(JSON) holds a spec of the containers (dict, list, tuple), the Python
scalars and the ``ModelBuffer`` internals.  ``load_run_state`` folds the two
back together with no template.

Tensors are saved as host numpy arrays and come back as tensors on the
``device`` the caller names (the run's); numpy arrays come back as numpy.
The port's run state has no ``jax.random`` key: ``round_payload`` takes
none, and the noise sources (FedGen's, DP's) seed themselves per round.

Writes go through ``io.save_pytree`` (atomic, bf16-safe, refusing
non-finite leaves) and resume through ``io.latest_loadable`` (newest
loadable file first, torn files skipped with a warning).
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import io
from repro_torch.core.server import ModelBuffer


def _encode(obj: Any, arrays: dict) -> Any:
    """Split ``obj`` into a JSON-safe spec and flat arrays."""
    if isinstance(obj, ModelBuffer):
        return {"k": "modelbuffer", "size": obj.size,
                "versions": list(obj._versions),
                "next_version": obj._next_version,
                "models": [_encode(m, arrays) for m in obj._buf]}
    if isinstance(obj, dict):
        return {"k": "dict", "keys": [_encode(k, arrays) for k in obj],
                "vals": [_encode(v, arrays) for v in obj.values()]}
    if isinstance(obj, (list, tuple)):
        return {"k": "list" if isinstance(obj, list) else "tuple",
                "items": [_encode(v, arrays) for v in obj]}
    if isinstance(obj, torch.Tensor):
        key = f"a{len(arrays)}"
        arrays[key] = obj.detach()
        return {"k": "tensor", "ref": key}
    if isinstance(obj, np.ndarray):
        key = f"a{len(arrays)}"
        arrays[key] = obj
        return {"k": "ndarray", "ref": key}
    if isinstance(obj, np.floating):
        return {"k": "py", "v": float(obj)}
    if isinstance(obj, (bool, np.bool_)):
        return {"k": "py", "v": bool(obj)}
    if isinstance(obj, (int, np.integer)):
        # JSON carries Python ints of any size (PCG64's 128-bit words)
        return {"k": "py", "v": int(obj)}
    if obj is None or isinstance(obj, (float, str)):
        return {"k": "py", "v": obj}
    raise TypeError(f"run-state serializer: unsupported {type(obj)!r}")


def _decode(spec: Any, arrays: dict, device) -> Any:
    kind = spec["k"]
    if kind == "modelbuffer":
        buf = ModelBuffer(spec["size"])
        for m, v in zip(spec["models"], spec["versions"]):
            buf._buf.append(_decode(m, arrays, device))
            buf._versions.append(v)
        buf._next_version = spec["next_version"]
        return buf
    if kind == "dict":
        return {_decode(k, arrays, device): _decode(v, arrays, device)
                for k, v in zip(spec["keys"], spec["vals"])}
    if kind == "list":
        return [_decode(v, arrays, device) for v in spec["items"]]
    if kind == "tuple":
        return tuple(_decode(v, arrays, device) for v in spec["items"])
    if kind == "tensor":
        return arrays[spec["ref"]].to(device)
    if kind == "ndarray":
        return arrays[spec["ref"]].numpy()
    if kind == "py":
        return spec["v"]
    raise ValueError(f"run-state spec: unknown kind {kind!r}")


def rng_state(rng: np.random.Generator) -> dict:
    """Snapshot a numpy Generator (a nested dict of ints and strings)."""
    return rng.bit_generator.state


def restore_rng(rng: np.random.Generator, state: dict) -> None:
    rng.bit_generator.state = state


def save_run_state(ckpt_dir: str, rnd: int, state: dict,
                   meta: dict | None = None) -> str:
    """Persist one round's run state as ``state_NNNNNN.npz`` + ``.meta``:
    any nesting of dict / list / tuple / tensors / numpy arrays / scalars
    / ``ModelBuffer``."""
    arrays: dict = {}
    spec = _encode(state, arrays)
    path = os.path.join(ckpt_dir, f"state_{rnd:06d}.npz")
    io.save_pytree(path, arrays, meta={"round": rnd, "spec": spec,
                                       **(meta or {})})
    return path


def load_run_state(path: str, device="cpu") -> tuple[dict, dict]:
    """``(state, meta)`` of one state file, tensors on ``device``; raises
    ``io.CORRUPT_ERRORS`` on a torn or invalid file."""
    arrays = io.load_flat(path)
    meta = io.load_meta(path)
    return _decode(meta["spec"], arrays, device), meta


def load_latest_state(ckpt_dir: str, device="cpu"
                      ) -> "tuple[dict, dict, int] | None":
    """``(state, meta, round)`` of the newest loadable state file, or
    ``None`` when the directory holds none (a fresh run); unreadable files
    are skipped, and all unreadable raises."""
    hit = io.latest_loadable(ckpt_dir, "state",
                             lambda path: load_run_state(path, device))
    if hit is None:
        return None
    (state, meta), rnd = hit
    return state, meta, rnd


def load_state_at(ckpt_dir: str, rnd: int, device="cpu") -> tuple[dict, dict]:
    """``(state, meta)`` of exactly round ``rnd``; no fallback."""
    path = os.path.join(ckpt_dir, f"state_{rnd:06d}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} missing: no state file for round "
                                f"{rnd}")
    return load_run_state(path, device)
