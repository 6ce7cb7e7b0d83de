"""Checkpointing: pytrees <-> ``.npz``, with a JSON metadata sidecar.

The port of ``repro.checkpoint.io``.  Layout: ``<dir>/round_000123.npz``
holds the leaves under their ``/``-joined key paths (dict keys as they
are, sequence indices as ``[i]``, dict keys in sorted order as
``repro_torch.tree`` visits them), and ``<dir>/round_000123.meta`` the
metadata.  Writes go to a ``.tmp`` file first and are moved into place
with ``os.replace``, so a crash mid-save leaves no truncated ``.npz``;
non-finite leaves are refused, so a poisoned run leaves no checkpoint a
resume would trust; bf16 leaves are stored as their ``uint16`` bits with a
dtype map (``__dtypes__``), since ``.npz`` has no bf16.

The reference writes its metadata and dtype map as msgpack; the port
writes JSON (the card's host has no msgpack).  The port's files are not
meant to be read by the reference or the other way round: the reference's
run state also holds a ``jax.random`` key, which has no counterpart here.
"""
from __future__ import annotations

import json
import logging
import os
import re
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_flatten

_LOG = logging.getLogger("repro_torch.checkpoint")


def _flatten(tree: Any, prefix: str = "", out: dict | None = None) -> dict:
    """``{"/"-joined key path: leaf}`` in flatten order."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{k}/", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}[{i}]/", out)
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _host_array(leaf: Any) -> np.ndarray:
    """A host leaf as a numpy array; bf16 tensors as their uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    return np.asarray(leaf)


def _finite(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return (not leaf.is_floating_point()
                or bool(torch.isfinite(leaf).all()))
    arr = np.asarray(leaf)
    return arr.dtype.kind != "f" or bool(np.isfinite(arr).all())


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def save_pytree(path: str, tree: Any, meta: dict | None = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # host copies first: the checks and the conversions below then read
    # nothing back from the device
    leaves = {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
              for k, v in _flatten(tree).items()}
    for key, leaf in leaves.items():
        if not _finite(leaf):
            raise ValueError(
                f"save_pytree({path!r}): non-finite values at leaf "
                f"{key!r}; refusing to write a corrupt checkpoint")
    flat = {k: _host_array(v) for k, v in leaves.items()}
    dtypes = {k: _dtype_name(v) for k, v in leaves.items()}
    flat["__dtypes__"] = np.frombuffer(json.dumps(dtypes).encode(), np.uint8)
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)
    if meta is not None:
        mtmp = re.sub(r"\.npz$", "", path) + ".meta.tmp"
        with open(mtmp, "w") as f:
            json.dump(meta, f)
        os.replace(mtmp, mtmp[:-4])


def load_flat(path: str) -> dict[str, torch.Tensor]:
    """``/``-joined key -> CPU tensor, the dtype map re-applied (bf16 bits
    reinterpreted)."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as data:
        dtypes = {}
        if "__dtypes__" in data:
            dtypes = json.loads(data["__dtypes__"].tobytes())
        out = {}
        for key in data.files:
            if key == "__dtypes__":
                continue
            arr = data[key]
            if dtypes.get(key) == "bfloat16":
                out[key] = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            else:
                out[key] = torch.from_numpy(arr)
    return out


def load_pytree(path: str, like: Any) -> Any:
    """Load into the structure of ``like``: each leaf with ``like``'s
    dtype, a tensor on its device or a numpy array as it is."""
    flat = load_flat(path)
    leaves, rebuild = tree_flatten(like)
    keys = list(_flatten(like))
    out = []
    for key, leaf in zip(keys, leaves):
        t = flat[key]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: saved {tuple(t.shape)}, expected "
                             f"{tuple(leaf.shape)}")
        out.append(t.to(leaf.device, leaf.dtype)
                   if isinstance(leaf, torch.Tensor)
                   else t.numpy().astype(np.asarray(leaf).dtype))
    return rebuild(out)


def load_meta(path: str) -> dict:
    with open(re.sub(r"\.npz$", "", path) + ".meta") as f:
        return json.load(f)


def save_round(ckpt_dir: str, rnd: int, tree: Any,
               meta: dict | None = None) -> str:
    path = os.path.join(ckpt_dir, f"round_{rnd:06d}.npz")
    save_pytree(path, tree, meta={"round": rnd, **(meta or {})})
    return path


# what a torn or corrupt file raises out of np.load and the sidecars: a
# truncated zip directory (BadZipFile), a zero-byte file (EOF / OSError), a
# member cut mid-stream (zlib -> OSError), missing keys or sidecar
# (KeyError), or garbage JSON (ValueError)
CORRUPT_ERRORS = (zipfile.BadZipFile, EOFError, OSError, KeyError, ValueError)


def latest_loadable(ckpt_dir: str, prefix: str, loader) -> \
        "tuple[Any, int] | None":
    """Walk ``<ckpt_dir>/<prefix>_NNNNNN.npz`` newest-first and return
    ``(loader(path), round)`` for the first file that loads.  A file that
    fails to load is skipped with a warning naming it; if every file fails,
    ``RuntimeError`` (restarting from scratch silently would discard the
    run's history).  ``None`` when no file matches."""
    if not os.path.isdir(ckpt_dir):
        return None
    pat = re.compile(re.escape(prefix) + r"_(\d+)\.npz$")
    rounds = sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                    if (m := pat.match(f)))
    if not rounds:
        return None
    failures: list[str] = []
    for rnd in reversed(rounds):
        path = os.path.join(ckpt_dir, f"{prefix}_{rnd:06d}.npz")
        try:
            return loader(path), rnd
        except CORRUPT_ERRORS as e:
            failures.append(f"{path}: {type(e).__name__}: {e}")
            _LOG.warning("skipping unreadable checkpoint %s (%s: %s)",
                         path, type(e).__name__, e)
    raise RuntimeError(
        f"latest_loadable: every {prefix} file in {ckpt_dir!r} is partial or "
        f"corrupt (crash mid-save?). Remove the directory to restart from "
        f"scratch.\n  " + "\n  ".join(failures))


def load_latest(ckpt_dir: str, like: Any) -> tuple[Any, int] | None:
    """The newest loadable ``round_*.npz`` into ``like``'s structure."""
    return latest_loadable(ckpt_dir, "round",
                           lambda path: load_pytree(path, like))
