"""Dry-run machinery: trace the train, prefill and serve steps of every
(arch × shape) on the meta device and describe one H100.

The port of ``repro.launch.dryrun_lib``.  The reference lowers and
compiles each step for a TPU v5e pod and reads XLA's cost and memory
analyses; the port runs each step eagerly on meta tensors (PyTorch's
shape-only device: no value is computed and nothing is allocated on any
device) at the published width and full depth, with

- ``torch.utils.flop_counter.FlopCounterMode`` for the FLOPs (aten's
  products, and each kernel launch by its cost function in
  ``launch.roofline``: the kernels are single operators,
  ``kernels.define_op``);
- ``launch.op_stats.OpStats`` for the launches, the bytes accessed, the
  op histogram and the peak of the bytes the step holds beyond its
  arguments;

and sets the reference's ``memory`` keys and a verdict on whether the step
fits the card (``roofline.DEVICE_MEMORY_BYTES``).  Eager tracing runs
every layer, so the counts are exact at full depth (the reference's
scan-over-layers program counts its body once and needs ``probe_costs``
for that: N/A here), one card has no mesh and no sharding (the
reference's ``make_production_mesh``, ``needs_fsdp`` and the shardings:
N/A), and nothing crosses between cards (``collective_bytes`` 0).

The train step is the reference's: ``steps.make_train_step`` under SGD
with momentum 0.9 and weight decay 1e-5, FedGKD's teacher a second
parameter tree.  The same functions give ``chip_smoke.py`` its prediction
of a step's peak on the card (``trace``, ``train_arguments``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import (META, InputShape, decode_input_specs,
                                      train_input_specs)
from repro_torch.launch import op_stats, roofline, steps
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import sgd
from repro_torch.tree import tree_leaves, tree_map

# long_500k applicability (the reference's): sub-quadratic backbones only;
# phi4 runs it through the sliding-window long variant
LONG_CTX_ARCHS = {"mamba2-2.7b", "zamba2-1.2b", "mixtral-8x7b"}
LONG_CTX_SWA_OVERRIDE = {"phi4-mini-3.8b": 4096}
KD_TOPK = 64            # cached_topk's teacher entries a position


@dataclasses.dataclass
class DryRunResult:
    """The reference's result with its JSON keys, and the port's
    ``fits`` (the step's arguments and peak within the card's memory),
    ``launches`` and the traced step's most called operators."""
    arch: str
    shape: str
    mesh: str
    kd_mode: str
    ok: bool
    seconds: float
    error: str = ""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_summary: str = ""
    memory: dict = dataclasses.field(default_factory=dict)
    report: Optional[dict] = None
    fits: Optional[bool] = None
    launches: int = 0
    largest: str = ""
    op_histogram: list = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Trace:
    """One traced step: FLOPs, bytes accessed, launches, the op histogram
    (its top and every operator's calls, ``counts``), the FLOPs by
    operator, the largest single allocation, and the reference's memory
    keys."""
    flops: float
    bytes_accessed: float
    launches: int
    histogram: list
    largest: str
    memory: dict
    counts: dict
    flops_by_op: dict


def resolve_config(arch: str, shape_name: str) -> ModelConfig:
    cfg = get_config(arch)
    if shape_name == "long_500k" and arch in LONG_CTX_SWA_OVERRIDE:
        cfg = cfg.replace(attn_window=LONG_CTX_SWA_OVERRIDE[arch])
    return cfg


def shape_supported(arch: str, shape_name: str) -> tuple[bool, str]:
    if shape_name != "long_500k":
        return True, ""
    if arch in LONG_CTX_ARCHS or arch in LONG_CTX_SWA_OVERRIDE:
        return True, ""
    return False, ("full-attention arch: 524k-token KV decode is quadratic-"
                   "class; skipped per DESIGN.md §Arch-applicability")


def _storages(tree) -> dict:
    """Storage -> the bytes the CUDA caching allocator counts for it, each
    storage once."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = op_stats.allocated_bytes(st.nbytes())
    return out


def trace(step, args: tuple) -> tuple[object, Trace]:
    """Run ``step(*args)`` under ``FlopCounterMode`` and ``OpStats``:
    (its outputs, the ``Trace``).  ``memory``: ``argument_size_in_bytes``
    (every argument storage once), ``output_size_in_bytes`` (the outputs'
    new storages), ``temp_size_in_bytes`` (the peak beyond the arguments,
    the outputs that are live at that point included) and
    ``alias_size_in_bytes`` (outputs in an argument's storage)."""
    arg_st = _storages(args)
    with FlopCounterMode(display=False) as flops, \
            op_stats.OpStats(arguments=args) as stats:
        out = step(*args)
    out_st = _storages(out)
    memory = {
        "argument_size_in_bytes": sum(arg_st.values()),
        "output_size_in_bytes": sum(v for k, v in out_st.items()
                                    if k not in arg_st),
        "temp_size_in_bytes": stats.peak_bytes,
        "alias_size_in_bytes": sum(v for k, v in out_st.items()
                                   if k in arg_st),
    }
    by_op = {str(op): n for op, n in
             flops.get_flop_counts().get("Global", {}).items()}
    return out, Trace(float(flops.get_total_flops()), stats.bytes_accessed,
                      stats.launches, stats.op_histogram(12),
                      stats.largest, memory, dict(stats.counts), by_op)


OPT = sgd(momentum=0.9, weight_decay=1e-5)


def make_train_step(cfg: ModelConfig, kd_mode: str = "teacher"):
    """The reference's dry-run train step: FedGKD (``kd_mode``) under SGD
    with momentum 0.9 and weight decay 1e-5."""
    return steps.make_train_step(cfg, OPT, kd_mode=kd_mode)


def train_arguments(cfg: ModelConfig, shape: InputShape,
                    kd_mode: str = "teacher") -> tuple:
    """(params, teacher, opt_state, batch) on the meta device: the teacher
    a parameter tree of its own under "teacher" (else ``()``), the SGD
    momentum, and the batch of ``shape`` (with the teacher's top-K logits
    and ids, (B, S_text, 64) bf16 and int32, under "cached_topk")."""
    params = transformer.init(None, cfg)
    teacher = (tree_map(torch.empty_like, params) if kd_mode == "teacher"
               else ())
    batch = train_input_specs(cfg, shape)
    if kd_mode == "cached_topk":
        b, s = batch["labels"].shape
        batch["teacher_topk_vals"] = torch.empty((b, s, KD_TOPK),
                                                 dtype=torch.bfloat16,
                                                 device=META)
        batch["teacher_topk_idx"] = torch.empty((b, s, KD_TOPK),
                                                dtype=torch.int32,
                                                device=META)
    return params, teacher, OPT.init(params), batch


def make_step(cfg: ModelConfig, mode: str, *, kd_mode: str = "teacher",
              prefill_last_only: bool = False):
    """The step of ``mode``: the train step, the prefill step (every
    position's logits unless ``prefill_last_only``) or one decode step."""
    if mode == "train":
        return make_train_step(cfg, kd_mode)
    if mode == "prefill":
        return steps.make_prefill_step(cfg, last_only=prefill_last_only)
    return steps.make_serve_step(cfg)


def arguments(cfg: ModelConfig, shape: InputShape,
              kd_mode: str = "teacher") -> tuple:
    """The meta arguments of ``make_step``'s step at ``shape``: the train
    step's (``train_arguments``), (params, batch) for prefill, (params,
    cache, tokens[, enc_out]) for decode over a ``seq_len`` cache."""
    if shape.mode == "train":
        return train_arguments(cfg, shape, kd_mode)
    params = transformer.init(None, cfg)
    if shape.mode == "prefill":
        return params, train_input_specs(cfg, shape)
    batch = decode_input_specs(cfg, shape)
    args = (params, batch["cache"], batch["tokens"])
    return args + ((batch["enc_out"],) if "enc_out" in batch else ())


def build(cfg: ModelConfig, shape_name: str, *, kd_mode: str = "teacher",
          prefill_last_only: bool = False) -> tuple:
    """(step, its meta arguments) at ``SHAPES[shape_name]``."""
    shape = SHAPES[shape_name]
    return (make_step(cfg, shape.mode, kd_mode=kd_mode,
                      prefill_last_only=prefill_last_only),
            arguments(cfg, shape, kd_mode))


def step_model_flops(cfg: ModelConfig, shape: InputShape,
                     kd_mode: str) -> float:
    """``roofline.model_flops`` of one step of ``shape``."""
    if shape.mode == "train":
        return roofline.model_flops(cfg, shape.global_batch * shape.seq_len,
                                    "train",
                                    with_teacher=(kd_mode == "teacher"),
                                    mtp=bool(cfg.mtp_depth))
    if shape.mode == "prefill":
        return roofline.model_flops(cfg, shape.global_batch * shape.seq_len,
                                    "prefill")
    return roofline.model_flops(cfg, shape.global_batch * 1, "decode")


def dtype_name(cfg: ModelConfig) -> str:
    return str(cfg.adtype).removeprefix("torch.")


def fits(memory: dict) -> bool:
    """Whether the step's arguments and its peak beyond them fit the
    card."""
    return (memory["argument_size_in_bytes"] + memory["temp_size_in_bytes"]
            <= roofline.DEVICE_MEMORY_BYTES)


def run_dryrun(arch: str, shape_name: str, *, kd_mode: str = "teacher",
               extra_cfg: Optional[dict] = None,
               prefill_last_only: bool = False,
               compute_roofline: bool = True) -> DryRunResult:
    ok, why = shape_supported(arch, shape_name)
    if not ok:
        return DryRunResult(arch, shape_name, roofline.MESH, kd_mode, False,
                            0.0, error="SKIP: " + why)
    t0 = time.time()
    try:
        cfg = resolve_config(arch, shape_name)
        if extra_cfg:
            cfg = cfg.replace(**extra_cfg)
        step, args = build(cfg, shape_name, kd_mode=kd_mode,
                           prefill_last_only=prefill_last_only)
        _, tr = trace(step, args)
        del args
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        return DryRunResult(arch, shape_name, roofline.MESH, kd_mode, False,
                            time.time() - t0,
                            error=f"{type(e).__name__}: {e}"[:2000])
    shape = SHAPES[shape_name]
    rep = roofline.RooflineReport(
        arch=arch, shape=shape_name, mesh=roofline.MESH, chips=1,
        hlo_flops=tr.flops, hlo_bytes=tr.bytes_accessed, collective_bytes=0.0,
        model_flops=step_model_flops(cfg, shape, kd_mode),
        dtype=dtype_name(cfg))
    return DryRunResult(
        arch, shape_name, roofline.MESH, kd_mode, True, time.time() - t0,
        flops=tr.flops, bytes_accessed=tr.bytes_accessed,
        collective_bytes=0.0,
        collective_summary=op_stats.collective_stats().summary(),
        memory=tr.memory, report=rep.row() if compute_roofline else None,
        fits=fits(tr.memory), launches=tr.launches, largest=tr.largest,
        op_histogram=tr.histogram)


def _gib(n: float) -> str:
    return f"{n / 2 ** 30:.2f} GiB"


def result_line(r: DryRunResult) -> str:
    """One line a result: FLOPs, bytes, launches, the arguments and the
    peak beyond them, the verdict against the card's memory, the dominant
    term and the largest single allocation."""
    if not r.ok:
        return f"[{r.mesh}] {r.arch} × {r.shape} ({r.kd_mode}): {r.error}"
    rep, mem = r.report or {}, r.memory
    need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    verdict = ("fits" if r.fits else
               f"DOES NOT FIT: needs {_gib(need)} of "
               f"{_gib(roofline.DEVICE_MEMORY_BYTES)}")
    return (f"[{r.mesh}] {r.arch} × {r.shape} ({r.kd_mode}): OK "
            f"{r.seconds:.1f}s flops={r.flops:.3e} bytes={r.bytes_accessed:.3e}"
            f" launches={r.launches} args={_gib(mem['argument_size_in_bytes'])}"
            f" peak={_gib(mem['temp_size_in_bytes'])} {verdict}"
            f" dominant={rep.get('dominant', '-')}"
            f" useful={rep.get('useful_flops_ratio', 0.0):.3f}"
            f" largest={r.largest} [{r.collective_summary}]")
