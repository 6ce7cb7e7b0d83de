"""The dry-run tooling of the port against the reference's, on the CPU.

``repro_torch.launch.roofline``, ``op_stats``, ``dryrun_lib`` and
``dryrun`` and the input specs of ``repro_torch.configs.base``, held to
``repro.launch.roofline``, ``repro.launch.dryrun_lib`` and
``repro.configs.base``: the input specs' shapes and dtypes for every
(arch × shape), ``model_flops``, ``shape_supported`` and
``resolve_config`` exactly; the roofline terms at the H100's constants;
the kernels' cost functions against the bounds ``PERF.md`` records; a
smoke step of each family traced on meta against the same step run on CPU
tensors; the dry-run at full width on the reference's test pairs; the
kernels' operators against their plain versions.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.launch import dryrun_lib as ref_dryrun
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config, get_smoke_config
from repro_torch.configs import input_specs
from repro_torch.configs.base import InputShape
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.kd_kl import ops as kd_ops
from repro_torch.kernels.kd_kl import ref as kd_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.launch import dryrun, dryrun_lib, op_stats, roofline
from repro_torch.models import transformer
from repro_torch.tree import tree_leaves, tree_map

MODES = ("train", "prefill", "decode")


def _paths(tree, prefix=()):
    """[(path, leaf)] of a port tree, NamedTuple fields by name."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for f in tree._fields
                for pl in _paths(getattr(tree, f), prefix + (f,))]
    return [(prefix, tree)]


def _ref_paths(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "name", None)))
                     for k in path)
        out.append((keys, leaf))
    return sorted(out, key=lambda pl: pl[0])


# ---------------------------------------------------------------------------
# input specs and the configs' resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_match_reference(arch, shape):
    """Every input of every (arch × shape), the decode caches key by key:
    the reference's shape and dtype, a meta tensor."""
    want = _ref_paths(ref_input_specs(ref_get_config(arch), shape))
    got = sorted(_paths(input_specs(get_config(arch), shape)),
                 key=lambda pl: pl[0])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, s) in zip(got, want):
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(s.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(s.dtype), path


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_and_resolution_match_reference(arch):
    """``model_flops`` at every mode, teacher and MTP setting,
    ``shape_supported`` and ``resolve_config`` at every shape: the
    reference's, exactly."""
    for shape in SHAPES:
        assert (dryrun_lib.shape_supported(arch, shape)
                == ref_dryrun.shape_supported(arch, shape))
        cfg = dryrun_lib.resolve_config(arch, shape)
        rcfg = ref_dryrun.resolve_config(arch, shape)
        common = ({f.name for f in dataclasses.fields(cfg)}
                  & {f.name for f in dataclasses.fields(rcfg)})
        for name in sorted(common):
            a, b = getattr(cfg, name), getattr(rcfg, name)
            if hasattr(a, "_asdict"):
                da, db = a._asdict(), b._asdict()
                a = {k: da[k] for k in da.keys() & db.keys()}
                b = {k: db[k] for k in da.keys() & db.keys()}
            assert a == b, (shape, name)
        assert cfg.param_count() == rcfg.param_count()
        assert cfg.active_param_count() == rcfg.active_param_count()
        for mode in MODES:
            for teacher in (False, True):
                for mtp in (False, True):
                    assert (roofline.model_flops(cfg, 4096, mode,
                                                 with_teacher=teacher,
                                                 mtp=mtp)
                            == ref_roofline.model_flops(
                                rcfg, 4096, mode, with_teacher=teacher,
                                mtp=mtp))
    assert dryrun_lib.LONG_CTX_ARCHS == ref_dryrun.LONG_CTX_ARCHS
    assert (dryrun_lib.LONG_CTX_SWA_OVERRIDE
            == ref_dryrun.LONG_CTX_SWA_OVERRIDE)
    assert SHAPES == {k: tuple(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_shape_only_init_is_meta(arch):
    """``transformer.init(None, cfg)``: every leaf on meta at full width,
    and at the smoke width the seeded init's paths, shapes and dtypes."""
    full = transformer.init(None, get_config(arch))
    assert {t.device.type for t in tree_leaves(full)} == {"meta"}
    cfg = get_smoke_config(arch)
    shape_only = _paths(transformer.init(None, cfg))
    seeded = _paths(transformer.init(torch.Generator().manual_seed(0), cfg))
    assert [p for p, _ in shape_only] == [p for p, _ in seeded]
    for (p, a), (_, b) in zip(shape_only, seeded):
        assert a.device.type == "meta" and b.device.type == "cpu", p
        assert (a.shape, a.dtype) == (b.shape, b.dtype), p


# ---------------------------------------------------------------------------
# the roofline and the kernels' costs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,peak", [("bfloat16", 989e12),
                                        ("float32", 67e12)])
def test_roofline_report_terms(dtype, peak):
    """The terms are their formulas at the H100's constants; one card has no
    collective term; the rows keep the reference's keys."""
    rep = roofline.RooflineReport("a", "s", roofline.MESH, 1, 3.2e15, 7.0e12,
                                  0.0, 2.4e15, dtype=dtype)
    assert rep.compute_s == 3.2e15 / peak
    assert rep.memory_s == 7.0e12 / 3.35e12
    assert rep.collective_s == 0.0
    assert rep.bound_time_s == max(rep.compute_s, rep.memory_s)
    assert rep.dominant == ("compute" if rep.compute_s > rep.memory_s
                            else "memory")
    assert rep.useful_flops_ratio == 2.4e15 / 3.2e15
    ref_row = ref_roofline.RooflineReport("a", "s", "m", 1, 1.0, 1.0, 0.0,
                                          1.0).row()
    assert set(ref_row) <= set(rep.row())
    assert (roofline.PEAK_BYTES, roofline.PEAK_FP32, roofline.PEAK_TF32,
            roofline.PEAK_BF16) == (3.35e12, 67e12, 495e12, 989e12)


# ResNet-8's convs at width 16 on 32x32: (H, Cin, Cout, k, stride)
RESNET8 = [(32, 3, 16, 3, 1), (32, 16, 16, 3, 1), (32, 16, 16, 3, 1),
           (32, 16, 32, 3, 2), (16, 32, 32, 3, 1), (32, 16, 32, 1, 2),
           (16, 32, 64, 3, 2), (8, 64, 64, 3, 1), (16, 32, 64, 1, 2)]


def _resnet8_step_bound():
    costs = [roofline.grouped_conv_cost(4, 64, *c) for c in RESNET8]
    return roofline.tf32x3_bound_ms(sum(c.nbytes for c in costs),
                                    sum(c.flops for c in costs))["bound_ms"]


# (what, bound ms as computed, as PERF.md's kernel table prints it)
BOUNDS = [
    ("B1 (2,048, 200,064) fp32",
     lambda: roofline.kd_kl_fwd_cost(2048, 200_064).bound()[0], "0.9785"),
    ("B1 (4092, 50280) fp32",
     lambda: roofline.kd_kl_fwd_cost(4092, 50_280).bound()[0], "0.491"),
    ("B1 bf16 (2,048, 200,064)",
     lambda: roofline.kd_kl_fwd_cost(2048, 200_064, 2).bound()[0], "0.4892"),
    ("B2 (4092, 50280)",
     lambda: roofline.kd_kl_bwd_cost(4092, 50_280).bound()[0], "0.737"),
    ("B2 bf16 (2,048, 200,064)",
     lambda: roofline.kd_kl_bwd_cost(2048, 200_064, 2).bound()[0], "0.7339"),
    ("B3 ResNet-8 K=4 step", _resnet8_step_bound, "0.0564"),
    ("B4 (64, 64, 4, 4, 32) causal",
     lambda: roofline.tf32x3_bound_ms(*roofline.flash_cost(
         64, 64, 64, 4, 4, 32)[:2])["bound_ms"], "0.00250"),
    ("B4 bf16 (2, 1,024, 24/8, 128) causal",
     lambda: roofline.bf16_flash_bound_ms(*roofline.flash_cost(
         2, 1024, 1024, 24, 8, 128, elt=2)[:2])["bound_ms"], "0.0196"),
    ("B4 bf16 (1, 160, 24/8, 128) window 64",
     lambda: roofline.bf16_flash_bound_ms(*roofline.flash_cost(
         1, 160, 160, 24, 8, 128, True, 64, elt=2)[:2])["bound_ms"],
     "0.0008"),
    ("B5 (4, 1023, 80, 64, 1, 128, 256)",
     lambda: roofline.tf32x3_bound_ms(*roofline.ssd_cost(
         4, 1023, 80, 64, 1, 128, 256)[:2])["bound_ms"], "0.0984"),
    ("B5 wrapper bf16 (4, 1,024, 64, 64, 1, 64, 256)",
     lambda: roofline.ssd_cost(4, 1024, 64, 64, 1, 64, 256, elt=2).bound(
         roofline.PEAK_BF16)[0], "0.0219"),
    ("B6 (4092, 50280)",
     lambda: roofline.row_lse_cost(4092, 50_280).bound()[0], "0.2457"),
    ("B6 bf16 (4,092, 50,280)",
     lambda: roofline.row_lse_cost(4092, 50_280, 2).bound()[0], "0.1228"),
]


@pytest.mark.parametrize("what,bound,printed", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_cost_functions_reproduce_the_kernel_table(what, bound, printed):
    """The cost functions give the bounds of PERF.md's kernel table, to
    its printed digits."""
    decimals = len(printed.split(".")[1])
    assert f"{bound():.{decimals}f}" == printed, what


def test_attended_pairs_is_the_mask_count():
    for sq, skv, causal, window in [(64, 64, True, None), (160, 160, True, 64),
                                    (7, 19, True, None), (19, 7, True, 3),
                                    (5, 9, False, None)]:
        mask = (fa_ref.causal_mask(sq, skv, window=window) if causal
                else torch.ones(sq, skv, dtype=torch.bool))
        assert roofline.attended_pairs(sq, skv, causal, window) == int(
            mask.sum())


# ---------------------------------------------------------------------------
# op statistics: a traced step on meta against the same step on CPU tensors
# ---------------------------------------------------------------------------

def test_op_stats_counts_storages_once():
    """Views and in-place results add nothing; a freed storage leaves the
    live count; sizes round to the allocator's 512 bytes."""
    x = torch.ones(100)                          # 400 bytes -> 512
    with op_stats.OpStats(arguments=(x,)) as st:
        y = x * 2                                # +512
        v = y.view(10, 10).t()                   # a view: nothing
        v.add_(1)                                # in place: nothing
        z = torch.cat([y, y])                    # +1024 (800 bytes): 1536
        del y, v                                 # y's storage freed: 1024
        w = z + 1                                # +1024: 2048, the peak
        del z, w
    assert st.peak_bytes == 1024 + 1024
    assert st.live == 0
    assert st.launches == 4 and st.counts["aten.view"] == 1
    assert op_stats.allocated_bytes(0) == 0
    assert op_stats.allocated_bytes(513) == 1024
    assert op_stats.collective_stats().summary() == "none"
    assert op_stats.collective_stats().total_bytes == 0


def _real(t, cfg, gen):
    if t.dtype == torch.int32:
        return torch.randint(0, cfg.vocab_size, t.shape, dtype=t.dtype,
                             generator=gen)
    return torch.randn(t.shape, generator=gen).to(t.dtype)


STEPS = [("phi4-mini-3.8b", "train", "teacher"),
         ("mixtral-8x7b", "train", "teacher"),
         ("mamba2-2.7b", "train", "teacher"),
         ("zamba2-1.2b", "train", "teacher"),
         ("deepseek-v3-671b", "train", "teacher"),
         ("seamless-m4t-large-v2", "train", "teacher"),
         ("llava-next-34b", "train", "cached_topk"),
         ("phi4-mini-3.8b", "prefill", "teacher"),
         ("zamba2-1.2b", "decode", "teacher"),
         ("deepseek-v3-671b", "decode", "teacher")]


@pytest.mark.parametrize("arch,mode,kd_mode", STEPS)
def test_meta_trace_matches_cpu_run(arch, mode, kd_mode):
    """A smoke-config step traced on meta and run on CPU tensors under
    ``OpStats``: the same op histogram, launches, bytes, FLOPs and
    memory."""
    cfg = get_smoke_config(arch)
    shape = InputShape("smoke", 48 if cfg.frontend else 32, 2, mode)
    step = dryrun_lib.make_step(cfg, mode, kd_mode=kd_mode)
    meta = dryrun_lib.arguments(cfg, shape, kd_mode)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init(gen, cfg)
    if mode == "train":
        teacher = (transformer.init(torch.Generator().manual_seed(1), cfg)
                   if kd_mode == "teacher" else ())
        real = (params, teacher, dryrun_lib.OPT.init(params),
                tree_map(lambda t: _real(t, cfg, gen), meta[3]))
    elif mode == "prefill":
        real = (params, tree_map(lambda t: _real(t, cfg, gen), meta[1]))
    else:
        real = (params, tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                                 meta[1]),
                *(_real(t, cfg, gen) for t in meta[2:]))
    _, on_meta = dryrun_lib.trace(step, meta)
    _, on_cpu = dryrun_lib.trace(step, real)
    assert on_meta.counts == on_cpu.counts
    assert on_meta.launches == on_cpu.launches
    assert on_meta.bytes_accessed == on_cpu.bytes_accessed
    assert on_meta.flops == on_cpu.flops > 0
    assert on_meta.memory == on_cpu.memory
    assert on_meta.memory["temp_size_in_bytes"] > 0


def test_kernels_are_single_costed_operations():
    """phi4-mini at full width (depth 2) traced on meta: each kernel launch
    is one operator, its FLOPs its cost function's (B4 a layer in the
    student's forward, its recomputation under ``remat`` and the teacher's);
    no softmax in a forward (the backward's P is the plain
    ``attention_bwd``'s, as in the reference)."""
    cfg = get_config("phi4-mini-3.8b").replace(n_layers=2)
    b, s = 1, 256
    step = dryrun_lib.make_train_step(cfg)
    _, tr = dryrun_lib.trace(step, dryrun_lib.train_arguments(
        cfg, InputShape("x", s, b, "train")))
    flash = roofline.flash_cost(b, s, s, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim_, elt=2)
    rows, vocab = b * s, cfg.vocab_size
    fwds = cfg.n_layers * (3 if cfg.remat else 2)
    want = {"repro_torch.flash_attention_fwd": (fwds, fwds * flash.flops),
            "repro_torch.kd_kl_fwd": (
                1, roofline.kd_kl_fwd_cost(rows, vocab).flops),
            "repro_torch.kd_kl_bwd": (
                1, roofline.kd_kl_bwd_cost(rows, vocab).flops),
            "repro_torch.row_lse_fwd": (
                1, roofline.row_lse_cost(rows, vocab).flops)}
    for op, (calls, flops) in want.items():
        assert tr.counts[op] == calls, op
        assert tr.flops_by_op[op] == flops, op
    # one softmax a layer: the backward's recomputation of P
    assert tr.counts.get("aten._softmax", 0) == cfg.n_layers


def test_ssd_scan_is_one_costed_operation():
    cfg = get_config("mamba2-2.7b").replace(n_layers=2)
    shape = InputShape("x", 512, 1, "prefill")
    _, tr = dryrun_lib.trace(dryrun_lib.make_step(cfg, "prefill"),
                             dryrun_lib.arguments(cfg, shape))
    ssm = cfg.ssm
    cost = roofline.ssd_cost(1, 512, ssm.n_heads, ssm.head_dim, ssm.n_groups,
                             ssm.d_state, 256)
    assert tr.counts["repro_torch.ssd_scan_fwd"] == 2
    assert tr.flops_by_op["repro_torch.ssd_scan_fwd"] == 2 * int(cost.flops)


# ---------------------------------------------------------------------------
# the dry-run and its CLI
# ---------------------------------------------------------------------------

# the reference's test pairs (tests/test_sharding_dryrun.py); its
# multi-pod pair is traced for the one card
PAIRS = [("phi4-mini-3.8b", "decode_32k"), ("mixtral-8x7b", "train_4k"),
         ("mamba2-2.7b", "long_500k"), ("phi4-mini-3.8b", "train_4k")]


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_run_dryrun_at_full_width(arch, shape):
    r = dryrun_lib.run_dryrun(arch, shape)
    assert r.ok, r.error
    assert r.flops > 0 and r.bytes_accessed > 0 and r.launches > 0
    ref_keys = {f.name for f in dataclasses.fields(ref_dryrun.DryRunResult)}
    assert ref_keys <= set(r.to_json())
    assert set(r.memory) == {"argument_size_in_bytes", "output_size_in_bytes",
                             "temp_size_in_bytes", "alias_size_in_bytes"}
    assert r.fits == (r.memory["argument_size_in_bytes"]
                      + r.memory["temp_size_in_bytes"]
                      <= roofline.DEVICE_MEMORY_BYTES)
    cfg = dryrun_lib.resolve_config(arch, shape)
    args = sum(t.numel() * t.element_size()
               for t in tree_leaves(transformer.init(None, cfg)))
    assert r.memory["argument_size_in_bytes"] >= args
    assert r.report["mesh"] == roofline.MESH and r.report["chips"] == 1
    assert r.report["collective_s"] == 0.0
    line = dryrun_lib.result_line(r)
    assert "flops=" in line and "peak=" in line and "dominant=" in line
    assert ("fits" in line) == r.fits
    json.dumps(r.to_json())


def test_dryrun_cli(tmp_path):
    """``--arch``/``--shape``/``--out`` append JSON lines; a SKIP is no
    failure."""
    out = tmp_path / "d" / "runs.jsonl"
    assert dryrun.main(["--arch", "mamba2-2.7b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "minitron-4b", "--shape", "long_500k",
                        "--kd", "none", "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["ok"] for r in rows] == [True, False]
    assert rows[1]["error"].startswith("SKIP")
    assert rows[0]["report"]["dominant"] in ("compute", "memory")


# ---------------------------------------------------------------------------
# the kernels' operators against their plain versions on the CPU
# ---------------------------------------------------------------------------

def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def test_kd_kl_operators_equal_plain_versions():
    lt, ls = _rand(37, 101, seed=1) * 2, _rand(37, 101, seed=2) * 2
    g = _rand(37, seed=3)
    for temp in (1.0, 2.0):
        got = kd_ops.kd_kl_fwd(lt, ls, temp)
        want = kd_ref.kd_kl_fwd_ref(lt, ls, temp)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        _, lse_t, lse_s = want
        assert torch.equal(kd_ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, temp),
                           kd_ref.kd_kl_bwd_ref(lt, ls, lse_t, lse_s, g, temp))
        assert torch.equal(kd_ops.row_lse_fwd(ls, temp),
                           kd_ref.row_logsumexp_ref(ls, temp))
    bf = ls.bfloat16()
    assert kd_ops.kd_kl_bwd(lt.bfloat16(), bf, lse_t, lse_s, g,
                            1.0).dtype == torch.bfloat16
    meta = [t.to("meta") for t in (lt, ls, g)]
    kl, lt_, ls_ = kd_ops.kd_kl_fwd(meta[0], meta[1], 1.0)
    assert [(t.shape, t.dtype) for t in (kl, lt_, ls_)] == [
        ((37,), torch.float32)] * 3
    assert kd_ops.kd_kl_bwd(meta[0], meta[1], kl, kl, meta[2],
                            1.0).shape == (37, 101)
    assert kd_ops.row_lse_fwd(meta[1].bfloat16(), 1.0).dtype == torch.float32
    with pytest.raises(ValueError):
        kd_ops.kd_kl_fwd(lt, ls[:, :5], 1.0)


@pytest.mark.parametrize("causal,window,hkv", [(True, None, 2),
                                               (True, 5, 2),
                                               (False, None, 4)])
def test_flash_operator_equals_plain_version(causal, window, hkv):
    q = _rand(2, 19, 4, 16, seed=4)
    k, v = _rand(2, 19, hkv, 16, seed=5), _rand(2, 19, hkv, 16, seed=6)
    got = fa_ops.flash_attention_fwd(q, k, v, causal, window)
    assert torch.equal(got, fa_ref.attention_ref(q, k, v, causal=causal,
                                                 window=window))
    assert got.is_contiguous()
    o = fa_ops.flash_attention_fwd(*(t.to("meta").bfloat16()
                                     for t in (q, k, v)), causal, window)
    assert (o.shape, o.dtype, o.device.type) == (q.shape, torch.bfloat16,
                                                 "meta")


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_operator_equals_plain_version(with_state):
    x, dt = _rand(2, 40, 4, 8, seed=7), torch.rand(2, 40, 4) * 0.1
    a = -torch.arange(1, 5, dtype=torch.float32)
    bm, cm = _rand(2, 40, 2, 6, seed=8), _rand(2, 40, 2, 6, seed=9)
    init = _rand(2, 4, 8, 6, seed=10) if with_state else None
    got = ssd_ops.ssd_scan_fwd(x, dt, a, bm, cm, 16, init)
    want = ssd_ref.ssd_scan_ref(x, dt, a, bm, cm, 16, init)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    y, state = ssd_ops.ssd_scan_fwd(
        *(t.to("meta") for t in (x, dt, a, bm, cm)), 16,
        None if init is None else init.to("meta"))
    assert (tuple(y.shape), tuple(state.shape)) == ((2, 40, 4, 8),
                                                    (2, 4, 8, 6))
    cost = roofline.kernel_cost(torch.ops.repro_torch.ssd_scan_fwd,
                                (x, dt, a, bm, cm, 16, init), None)
    plan = ssd_ops.ssd_plan(2, 40, 4, 8, 2, 6, 16)
    assert cost.scratch == 4 * sum(math.prod(s) for s in (
        plan.states_shape, plan.cb_shape, plan.decay_shape))
    assert cost.nbytes == roofline.ssd_cost(2, 40, 4, 8, 2, 6, 16,
                                            init_state=with_state).nbytes
