#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: kernels and main paths.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
``nvcc`` and PyTorch built for CUDA.  It imports the port (``src/repro_torch``)
and nothing of JAX or of the JAX package, and

  1. prints the card's name and power limit (``nvidia-smi``);
  2. builds the port's CUDA kernels from ``src/repro_torch/csrc`` and prints
     the build's seconds and the compiler's register report;
  3. holds every kernel against its plain PyTorch version on the card at
     the paths' shapes — KD-KL forward and backward at (256, 10),
     FedDistill+'s (64, 10), (256, 100), (256, 200), a ragged (1000, 37),
     the text path's (64, 4) and (64, 5) and the LM path's (4092, 50280);
     the client-batched conv at all 9 ResNet-8 layers at K=4, N=64, at
     K=1, N=64 (the sequential route's step), at K=2 and K=3, N=64 (the
     async loop's refill waves and the fault-tolerant round's retried
     subsets), at K=1, N=256 and at K=1
     with the teacher precompute's chunk sizes, and at ResNet-50's 23
     distinct shapes at 64x64 (53 convs) at K=4, N=64 and at K=1 with
     N=256 and the teacher's chunk sizes; flash attention at the text
     path's (B, S, Hq, Hkv, D) = (64, 64, 4, 4, 32) of a local step and
     a teacher forward, (256, ...) of an evaluation batch, and for
     coverage at the row counts a per-shard teacher pass would take, GQA
     with a window, non-causal ragged S = 100 at D = 128, and S = 1; the SSD scan at the LM path's
     (B, L, H, P, G, N, chunk) = (4, 1023, 80, 64, 1, 128, 256) of a step,
     (8, ...) of an evaluation and (1, 512, ...) of the round check, and
     for coverage at the smoke config's layer, two groups at a ragged
     length, L = 1, one 4,096-token sequence, one full-width chunk, a
     chunk of 48 and P, N not multiples of 4; the row logsumexp at
     (4092, 50280), (8184, 50280), one and two rows and ragged shapes —
     to 1e-5 of the plain version's largest magnitude (fp32, TF32 off;
     for the SSD scan, where its fp32 plain version is itself further than
     that from float64, to being no further from float64 than the plain
     version), and times the kernel,
     the plain version and, where one exists, one library call (cuDNN's
     grouped ``conv2d``; ``kl_div`` of ``log_softmax``;
     ``scaled_dot_product_attention``; ``torch.logsumexp``) on the device:
     CUDA-graph replays between CUDA events, so the host's enqueue cost is
     left out; an empty kernel is timed the same way (the launch floor).
     The conv is totalled per group (K=4, K=2, K=3 and K=1 steps, K=1 eval, K=1
     teacher; ResNet-50's K=4 step and K=1 teacher/eval, each shape as
     often as the network has it) against cuDNN, with the shapes where
     cuDNN is faster; the conv's, flash attention's and the SSD scan's
     bounds count their 3xTF32 arithmetic, with the fp32 CUDA-core bound
     beside them.  Then the vmap rules: B1/B2 under ``torch.func.vmap`` of
     ``grad`` over 8 clients, and B3 over K=4 single-client convs (output,
     input and weight gradients), against the plain versions, one launch
     for all the vmapped clients;
  4. drives the paths, each with every launch count set to 0 just before
     and read just after, and fails if a kernel of the path was not
     launched:
     a. ResNet-8 (``run_federated``, client-batched vmap executor): FedGKD
        at full width (16; 32x32x3 inputs, batch 64, 20 clients at C=0.2
        so K=4, 10 classes), with only depth cut (train size, one local
        epoch, 5 batches per client, 3 rounds);
     b. text (``run_federated``, sequential executor): FedGKD on AG News
        with the DistilBERT-class encoder at the repo's full width (4
        layers, d_model 128, 4 heads, sequence 64, vocab 2000; batch 64,
        20 clients at C=0.2 so K=4, Adam at lr 1e-5), depth cut to 3,000
        examples, 5 batches per client and 3 rounds;
     c. LM (``launch.train.run_serial``): FedGKD on mamba2-2.7b at its
        published width (d_model 2560, 80 heads of 64, state 128, chunk
        256, vocab 50,280), depth cut to 4 layers and fp32, 4 clients x 2
        batches of 4 sequences of 1,024 tokens, 3 rounds (SGD momentum
        0.9, lr 0.1, gamma 0.2, M = 3);
     then one FedAvg round of each;
     d. the paper's baselines on the ResNet-8 path's setup
        (``run_federated``, ``executor="auto"``, 2 rounds each): FedProx,
        FedGKD with the MSE loss, FedGKD-VOTE and FedGKD+ on the
        client-batched vmap executor, MOON, FedDistill+, SCAFFOLD, FedDyn
        and FedGen on the sequential one; each must take its route and
        launch the kernels of its step (B3 for all; B1/B2 for FedGKD+ and
        FedDistill+);
     e. ResNet-50 (``run_federated``, ``executor="auto"``: the
        client-batched vmap route): FedGKD on Tiny-ImageNet at full width
        (64x64x3 inputs, 200 classes, batch 64, 20 clients at C=0.2 so
        K=4, gamma 0.1, M=5), depth cut to 9,000 examples, one local
        epoch, 5 batches per client, 3 rounds; B3 at all 53 convs, B1/B2;
        its peak device memory;
     f. the vmapped round body (``executor="vmap"``): the TOY task's MLP,
        2 rounds each of FedGKD (B1/B2 under vmap) and of MOON,
        FedDistill+, SCAFFOLD, FedDyn and FedGen (their client hooks
        vmapped too); ResNet-8 FedGKD with ``client_batched=False`` (B3
        and B1/B2 under vmap) for one round, held to 1e-5 against the
        client-batched route's round;
     g. the resilience layer on the ResNet-8 path's setup
        (``run_resilience``): FedGKD under DP (2 rounds; every clipped
        delta within the clip norm), under the reference's CHAOS faults (3
        rounds; the fault counters equal the CPU run's), killed after round
        2 of 4 and resumed from its checkpoints (records equal and params
        bitwise equal to the uninterrupted run's), and through the
        buffered-async executor (B=2 of K=4, straggler tail, availability
        windows; 6 aggregations: the virtual clock, versions, staleness and
        buffers equal the CPU run's, pipelined within 1e-5 of
        single-stream, seconds per aggregation of both; under CHAOS killed
        after aggregation 3 and resumed, bitwise); the shapes B1, B2 and
        B3 were called with in these runs recorded, and each kernel then
        held to its plain version at every one of them (the K = 1-3 waves'
        steps and teacher chunks among them); the LM run of c. also
        reports its simulated straggler barrier (``sim_seconds``);
  5. profiles one steady-state round of each path (``torch.profiler``;
     FedGKD, MOON and FedGen for the baselines, and an async aggregation
     pipelined and not, each with its host synchronisations counted by
     line in a run without the profiler): host wall time, the
     device's busy time and idle share, device time by kernel, and the
     device time inside the conv's gradients (``grouped_conv_dw``,
     ``grouped_conv_dx``) with their kernels by name;
  6. runs each path's first round on the card and on the CPU from the
     same init (FedGKD, each of the nine baselines, and FedGKD under DP,
     under faults and async's aggregation 1) and holds the
     card's parameters after that round to 1e-4 of the CPU's, where the
     round must have moved them by at least 1e-3 (the text path at Adam
     lr 1e-3 for this check: at its lr 1e-5 a round moves them by about
     5e-5, so no check at 1e-4 could fail; the LM path at full width with
     1 layer, 2 clients x 1 batch of one 513-token sequence, which the CPU
     runs in reasonable time; ResNet-50 at lr 1e-3, ``R50_CHECK_LR``
     says why; the TOY runs of phase f at the task's lr).

It exits non-zero on any failure.  The last lines of its output are the
kernels' JSON record, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s outside the
# tensor cores, dense TF32 FLOP/s on them.  B1, B2 and B6 are fp32 on the
# CUDA cores; B3, B4 and B5 run their products in 3xTF32 on the tensor
# cores, three TF32 products for each fp32 one, so their bound counts
# 3 x FLOP at the TF32 peak (the fp32 CUDA-core bound is printed beside it)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
KERNEL_TOL = 1e-5          # of max |plain|, fp32 with TF32 off
ROUND_TOL = 1e-4           # card vs CPU params after one round, fp32
MIN_MOVE = 10              # round 1 must move the params >= this x ROUND_TOL
# the text path trains under Adam at lr 1e-5, which moves a parameter by
# about lr per step: 5 steps stay below ROUND_TOL, so its card-vs-CPU round
# runs at the CPU tests' lr instead
TEXT_CHECK_LR = 1e-3
# ResNet-8 convs at width 16 on 32x32 inputs: (name, H, Cin, Cout, k, stride)
RESNET8_CONVS = [
    ("stem", 32, 3, 16, 3, 1),
    ("block1.conv1", 32, 16, 16, 3, 1),
    ("block1.conv2", 32, 16, 16, 3, 1),
    ("block2.conv1", 32, 16, 32, 3, 2),
    ("block2.conv2", 16, 32, 32, 3, 1),
    ("block2.proj", 32, 16, 32, 1, 2),
    ("block3.conv1", 16, 32, 64, 3, 2),
    ("block3.conv2", 8, 64, 64, 3, 1),
    ("block3.proj", 16, 32, 64, 1, 2),
]


def resnet50_shapes(hw: int = 64) -> list[tuple]:
    """ResNet-50's distinct conv shapes at ``hw`` x ``hw`` inputs, each as
    (name of its first conv, H, Cin, Cout, k, stride, how many of the 53
    convs have it)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.models.resnet import resnet50_convs

    shapes: dict = {}
    for name, *shape in resnet50_convs(hw):
        first, count = shapes.get(tuple(shape), (name, 0))
        shapes[tuple(shape)] = (first, count + 1)
    return [(name, *shape, count) for shape, (name, count) in shapes.items()]
# the baselines phase: rounds of each of the nine at full ResNet-8 width
BASELINE_ROUNDS = 2
# the ResNet-50 path (Tiny-ImageNet at 64x64): 3 rounds of K=4 of 20
# clients, 5 batches of 64 a client
R50_HW, R50_ROUNDS = 64, 3
# its card-vs-CPU round runs at lr 1e-3, not the task's 0.05: from the
# random init the local loss climbs from ~8 to ~70 in 5 steps at 0.05, and
# fp32 rounding grows ~10x a step (two summation orders on the card itself
# are 1.2e-7 apart after 1 step, 1.1e-5 after 2, 1.5e-4 after 3, 1.3e-3
# after 5), so no fp32 check at 1e-4 could pass there; at 1e-3 a round
# moves the params by ~2e-2 (PERF.md, PR 17)
R50_CHECK_LR = 1e-3
# the vmapped-body phase: the TOY task's MLP through executor="vmap", 2
# rounds each of FedGKD and the five algorithms with client hooks
VMAP_ALGOS = ["fedgkd", "moon", "feddistill+", "scaffold", "feddyn", "fedgen"]
VMAP_ROUNDS = 2
VMAP_TOL = 1e-5            # the vmapped body against the client-batched one
# the resilience phase on the ResNet-8 path's setup: DP at the reference's
# defaults, the reference's CHAOS fault profile (tests/test_faults.py), and
# the buffered-async executor at B=2 of the K=4 cohort with a straggler
# tail and staggered availability, for 6 aggregations
RES_DP = dict(clip_norm=1.0, noise_multiplier=0.5)
RES_CHAOS = dict(crash_prob=0.2, corrupt_prob=0.05)
RES_DP_ROUNDS, RES_FAULT_ROUNDS, RES_KILL_ROUNDS, RES_AGGS = 2, 3, 4, 6
PIPE_TOL = 1e-5            # pipelined against single-stream async, fp32
# what a resumed run must reproduce exactly
REC_FIELDS = ("round", "test_acc", "test_loss", "mean_local_loss",
              "sim_time", "version", "mean_staleness", "sampled")
KD_SHAPES = [(256, 10), (64, 10), (128, 10), (192, 10), (256, 100), (256, 200),
             (1000, 37), (64, 4), (64, 5), (4092, 50280)]
# the LM path (mamba2-2.7b at full width, 4 layers): batch 4 of 1,024-token
# sequences, so 1,023 positions a step; evaluation on 8 such sequences
LM_BATCH, LM_SEQ, LM_EVAL_BATCH = 4, 1024, 8
LM_VOCAB = 50280
# SSD scan (B, L, H, P, G, N, chunk) for coverage beyond the LM path's own:
# the smoke config's, two B/C groups at a ragged length, one token, one
# sequence at train_4k's published length (16 chunks through the state
# pass), one chunk at full width, a chunk that is not a multiple of 16, and
# P and N that are not multiples of 4 (4-byte copies)
SSD_COVERAGE = [(2, 39, 16, 16, 1, 16, 16), (1, 300, 8, 64, 2, 64, 128),
                (2, 1, 8, 64, 1, 128, 1), (1, 4096, 80, 64, 1, 128, 256),
                (1, 256, 80, 64, 1, 128, 256), (2, 200, 8, 64, 1, 128, 48),
                (1, 70, 4, 10, 1, 10, 32)]
SSD_SWEEP_BATCHES = [1, 2, 3, 4, 5, 8]     # B5's time against its grid
# row logsumexp (T, V) beyond the LM path's: one and two rows, ragged
ROW_LSE_COVERAGE = [(1, 50280), (2, 50280), (300, 1100), (1, 7)]
# the LM path: run_serial's FedGKD on mamba2-2.7b, depth 64 -> 4 layers,
# 3 rounds of 4 clients x 2 batches (the CLI's defaults otherwise: SGD
# momentum 0.9, lr 0.1, gamma 0.2, M = 3)
LM_ARCH, LM_LAYERS, LM_ROUNDS = "mamba2-2.7b", 4, 3
# the simulated straggler tail of the LM run (``run_serial``'s
# ``sim_seconds``; virtual time, no device work)
LM_STRAGGLER_FRAC = 0.25
LM_RUN = dict(n_clients=4, batches_per_round=2, batch=LM_BATCH, seq=LM_SEQ,
              gamma=0.2, buffer_m=3, lr=0.1, seed=0)
# its card-vs-CPU round check: 1 layer, 2 clients x 2 batches of 1 sequence
# of 513 tokens (512 positions: two chunks), 1 round, on both devices.  The
# second step's teacher (the initial model) differs from its student, yet
# at this width round 1's KD term comes out exactly 0 on both devices, and
# a second round is not reproducible to ROUND_TOL in fp32 (PERF.md §6):
# the KD term is gated on the main run instead, and B1/B2 at its shape
LM_CHECK = dict(LM_RUN, n_clients=2, batch=1, seq=513)
LM_KERNELS = ["ssd_scan_fwd", "row_logsumexp", "kd_kl_fwd", "kd_kl_bwd"]
# the CUDA kernels' names in csrc/*.cu, for the profile's device time by
# kernel, and the port's named ranges (the SSD scan's autograd backward)
PORT_KERNELS = ["kd_kl_", "conv_fwd_kernel", "flash_fwd_kernel", "row_lse_",
                "ssd_chunk_kernel", "ssd_pass_kernel", "ssd_out_kernel"]
PORT_RANGES = ["ssd_scan_backward", "grouped_conv_dw", "grouped_conv_dx"]
# flash attention (B, S, Hq, Hkv, D, causal, window) beyond the text path's
# own: GQA with a window, non-causal ragged at D = 128, one token
FLASH_COVERAGE = [(4, 128, 8, 2, 64, True, 32), (8, 100, 4, 4, 128, False, None),
                  (64, 1, 4, 4, 32, True, None)]


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()``: ``reps`` back-to-back calls captured in
    one CUDA graph, replayed ``replays`` times between two CUDA events, so
    the host's cost of enqueueing a call (Python, ctypes, allocation) is
    not in the figure."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def taps_in_bounds(size: int, k: int, stride: int, out: int, lo: int) -> int:
    """Filter taps along one axis that land inside the input, summed over
    the outputs: the kernel skips the taps that fall on SAME padding."""
    return sum(1 for o in range(out) for i in range(k)
               if 0 <= o * stride - lo + i < size)


def bound_ms(nbytes: float, ops: float,
             peak: float = PEAK_FP32) -> tuple[float, str]:
    """The least time of the work on the card: the larger of its bytes at
    the memory rate and its operations at ``peak``."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32x3_bound_ms(nbytes: float, flops: float) -> dict:
    """B3's, B4's and B5's bounds: in 3xTF32 (3 x FLOP at the TF32 peak),
    the arithmetic they use, with the fp32 CUDA-core bound beside it."""
    b, by = bound_ms(nbytes, 3 * flops, PEAK_TF32)
    return dict(bound_ms=b, bound_by=by,
                fp32_bound_ms=bound_ms(nbytes, flops)[0])


def compare(name: str, got, want) -> float:
    """Max |got - want|; raises if it exceeds KERNEL_TOL·max|want|."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not math.isfinite(err) or err > KERNEL_TOL * max(scale, 1e-30):
        raise AssertionError(f"{name}: max abs err {err:.3e} exceeds "
                             f"{KERNEL_TOL} x max|plain| = {scale:.3e}")
    return err


def launch_floor_ms() -> float:
    """Device time of one launch of an empty kernel (``csrc/empty.cu``),
    timed as the kernels are: what any launch costs, work or none."""
    import torch

    from repro_torch.kernels import build

    lib = build.library()
    return time_ms(lambda: build.check(lib.empty_launch(
        torch.cuda.current_stream().cuda_stream), "empty_launch"))


def check_kd_kl(dev) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.kd_kl import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)
    temp = 1.0
    rec = {"kd_kl_fwd": {"max_abs_err": 0.0}, "kd_kl_bwd": {"max_abs_err": 0.0}}
    for rows, vocab in KD_SHAPES:
        lt = torch.randn(rows, vocab, device=dev, generator=gen) * 2
        ls = torch.randn(rows, vocab, device=dev, generator=gen) * 2
        g = torch.randn(rows, device=dev, generator=gen)
        kl, lse_t, lse_s = ops.kd_kl_fwd(lt, ls, temp)
        want = ref.kd_kl_fwd_ref(lt, ls, temp)
        err_f = max(compare(f"kd_kl_fwd{(rows, vocab)}:{n}", a, b)
                    for n, a, b in zip(("kl", "lse_t", "lse_s"),
                                       (kl, lse_t, lse_s), want))
        dls = ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, temp)
        err_b = compare(f"kd_kl_bwd{(rows, vocab)}", dls,
                        ref.kd_kl_bwd_ref(lt, ls, lse_t, lse_s, g, temp))
        rec["kd_kl_fwd"]["max_abs_err"] = max(rec["kd_kl_fwd"]["max_abs_err"], err_f)
        rec["kd_kl_bwd"]["max_abs_err"] = max(rec["kd_kl_bwd"]["max_abs_err"], err_b)

        def library_fwd():
            return F.kl_div(F.log_softmax(ls / temp, -1),
                            F.log_softmax(lt / temp, -1), reduction="none",
                            log_target=True).sum(-1) * (temp * temp)

        compare(f"library kl_div{(rows, vocab)}", library_fwd(), want[0])
        n = rows * vocab
        fwd = dict(ms=time_ms(lambda: ops.kd_kl_fwd(lt, ls, temp)),
                   plain_ms=time_ms(lambda: ref.kd_kl_fwd_ref(lt, ls, temp)),
                   library_ms=time_ms(library_fwd))
        # bytes: both logits read once, three (rows,) outputs written;
        # operations: ~12 per element (2 scalings, 2 exps, the running
        # max/sum updates and the cross term)
        fwd["bound_ms"], fwd["bound_by"] = bound_ms(8 * n + 12 * rows, 12 * n)
        bwd = dict(ms=time_ms(lambda: ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, temp)),
                   plain_ms=time_ms(lambda: ref.kd_kl_bwd_ref(
                       lt, ls, lse_t, lse_s, g, temp)),
                   library_ms=None)
        # bytes: both logits and three row vectors read, the gradient
        # written; operations: ~8 per element (2 scalings, 2 exps, 4 arith)
        bwd["bound_ms"], bwd["bound_by"] = bound_ms(12 * n + 12 * rows, 8 * n)
        log(f"  kd_kl ({rows:4d},{vocab:3d}) fwd err {err_f:.2e} "
            f"kernel {fwd['ms']:.5f} ms plain {fwd['plain_ms']:.5f} ms "
            f"library {fwd['library_ms']:.5f} ms bound {fwd['bound_ms']:.3g} "
            f"ms | bwd err {err_b:.2e} kernel {bwd['ms']:.5f} ms plain "
            f"{bwd['plain_ms']:.5f} ms bound {bwd['bound_ms']:.3g} ms")
        if (rows, vocab) == (256, 10):          # the CIFAR-10 main path
            rec["kd_kl_fwd"].update(fwd)
            rec["kd_kl_bwd"].update(bwd)
            log(f"  launch floor: an empty kernel {launch_floor_ms():.5f} ms "
                f"(CUDA-graph replays, as the kernels above)")
    return [
        dict(name="kd_kl_fwd", route="cuda", source="src/repro_torch/csrc/kd_kl.cu",
             replaces="src/repro/kernels/kd_kl/kernel.py:33", **rec["kd_kl_fwd"]),
        dict(name="kd_kl_bwd", route="cuda", source="src/repro_torch/csrc/kd_kl.cu",
             replaces="src/repro/kernels/kd_kl/kernel.py:113", **rec["kd_kl_bwd"]),
    ]


def check_conv(dev, teacher_ns: list[int], r50_teacher_ns: list[int]) -> dict:
    """The conv in eight groups.  At every ResNet-8 layer: K=4, N=64 (a
    local step of the client-batched route), K=1, N=64 (a local step of the
    sequential route), K=2 and K=3, N=64 (the async loop's refill waves and
    the fault-tolerant round's retried subsets), K=1, N=256 (an evaluation
    batch) and K=1 at ``teacher_ns`` (the teacher precompute's chunks).  At every distinct
    ResNet-50 shape at 64x64 (23 shapes, 53 convs): K=4, N=64 (a local
    step) and K=1 at N=256 and ``r50_teacher_ns`` (evaluation and the
    teacher's chunks); a ResNet-50 group's totals count each shape as often
    as the network has it.  Per group it prints the kernel's, cuDNN's and
    the bound's total ms and the shapes where cuDNN is faster; the record's
    times are the ResNet-8 local step's, with the groups beside them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.grouped_conv import ops, ref

    gen = torch.Generator(device=dev).manual_seed(1)
    r8 = [c + (1,) for c in RESNET8_CONVS]
    r50 = resnet50_shapes(R50_HW)
    groups = {"K=4 step": ([(4, 64)], r8), "K=1 step": ([(1, 64)], r8),
              "K=2 step": ([(2, 64)], r8), "K=3 step": ([(3, 64)], r8),
              "K=1 eval": ([(1, 256)], r8),
              "K=1 teacher": ([(1, n) for n in teacher_ns], r8),
              "R50 K=4 step": ([(4, 64)], r50),
              "R50 K=1 teacher/eval": ([(1, 256)] + [(1, n) for n in
                                                     r50_teacher_ns], r50)}
    rec = dict(max_abs_err=0.0, groups={})
    for group, (calls, convs) in groups.items():
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0,
                   flops=0.0, slower=[])
        # ResNet-50's teacher chunks: few timed calls (the plain version
        # takes tens of ms a call there)
        reps = (dict(reps=3, replays=2) if group.startswith("R50 K=1")
                else {})
        for k, n in calls:
            for name, h, cin, cout, kk, s, count in convs:
                x = torch.randn(k, n, h, h, cin, device=dev, generator=gen)
                w = torch.randn(k, kk, kk, cin, cout, device=dev,
                                generator=gen) / math.sqrt(kk * kk * cin)
                oh, lo, hi = ref.same_pads(h, kk, s)
                want = ref.grouped_conv_ref(x, w, s, "SAME")
                err = compare(f"grouped_conv K={k} N={n} {name}",
                              ops.grouped_conv_fwd(x, w, s, "SAME"), want)
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                # the library yardstick: cuDNN's grouped conv2d on the
                # inputs packed channel-wise (client k's channels are group
                # k) and padded as JAX pads SAME; the packing is not timed
                xg = F.pad(x.permute(1, 0, 4, 2, 3).reshape(n, k * cin, h, h),
                           (lo, hi, lo, hi))
                wg = w.permute(0, 4, 3, 1, 2).reshape(k * cout, cin, kk, kk)
                lib = F.conv2d(xg, wg, stride=s, groups=k)
                compare(f"library conv2d K={k} N={n} {name}",
                        lib.reshape(n, k, cout, oh, oh).permute(1, 0, 3, 4, 2),
                        want)
                del want, lib
                t = dict(ms=time_ms(lambda: ops.grouped_conv_fwd(x, w, s, "SAME"),
                                    **reps),
                         plain_ms=time_ms(lambda: ref.grouped_conv_ref(
                             x, w, s, "SAME"), **reps),
                         library_ms=time_ms(lambda: F.conv2d(
                             xg, wg, stride=s, groups=k), **reps))
                nbytes = 4 * (x.numel() + w.numel() + k * n * oh * oh * cout)
                # multiply-adds of the taps inside the input only
                flops = (2 * k * n * cout * cin
                         * taps_in_bounds(h, kk, s, oh, lo) ** 2)
                t.update(tf32x3_bound_ms(nbytes, flops))
                plan = ops.conv_plan(k, n, h, h, cin, cout, kk, kk, s, "SAME")
                log(f"  conv K={k} N={n:4d} {name:13s} x{count} ({h}x{h}, "
                    f"{cin}->{cout}, {kk}x{kk} s{s}) err {err:.2e} kernel "
                    f"{t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms library "
                    f"{t['library_ms']:.4f} ms bound {t['bound_ms']:.4f} ms "
                    f"({t['bound_by']}; fp32 {t['fp32_bound_ms']:.4f}) tile "
                    f"{plan.tile_imgs}x{plan.tile_rows}x{plan.tile_cols} "
                    f"chunk {plan.chunk} bn {plan.bn} stages {plan.stages} "
                    f"smem {plan.smem_bytes} grid {plan.grid}")
                for key in ("ms", "plain_ms", "library_ms"):
                    tot[key] += count * t[key]
                tot["nbytes"] += count * nbytes
                tot["flops"] += count * flops
                if t["ms"] > t["library_ms"]:
                    tot["slower"].append(f"N={n} {name}")
                del x, w, xg, wg
        # the group's bound: its bytes and FLOP summed, then bounded
        bound = tf32x3_bound_ms(tot["nbytes"], tot["flops"])
        n_shapes = len(calls) * len(convs)
        log(f"  conv group {group}: kernel {tot['ms']:.4f} ms cuDNN "
            f"{tot['library_ms']:.4f} ms plain {tot['plain_ms']:.4f} ms bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, 3xTF32; fp32 "
            f"{bound['fp32_bound_ms']:.4f}); slower than cuDNN at "
            f"{len(tot['slower'])} of {n_shapes} shapes {tot['slower']}")
        rec["groups"][group] = dict(
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            library_ms=tot["library_ms"], **bound,
            slower_than_library=len(tot["slower"]), shapes=n_shapes)
        if group == "K=4 step":                # one local step's forward
            rec.update(ms=tot["ms"], plain_ms=tot["plain_ms"],
                       library_ms=tot["library_ms"], **bound)
    torch.cuda.empty_cache()
    return dict(name="grouped_conv_fwd", route="cuda",
                source="src/repro_torch/csrc/grouped_conv.cu",
                replaces="src/repro/kernels/grouped_conv/kernel.py:36", **rec)


def check_vmap_rules(dev) -> None:
    """The kernels' ``torch.func`` vmap rules on the card, against the plain
    versions on the same inputs: B1/B2 under ``vmap(grad)`` over 8 clients
    of the TOY path's (32, 10), and B3 under ``vmap(grad)`` of a
    single-client conv over K=4 clients at two ResNet-8 layers (the
    vmapped body's conv: the rule folds the vmapped axis into K), output
    and both gradients, to ``KERNEL_TOL`` of max|plain|."""
    import torch
    from torch.func import grad, vmap

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.grouped_conv import ops as conv_ops
    from repro_torch.kernels.grouped_conv import ref as conv_ref
    from repro_torch.kernels.kd_kl import ops as kd_ops
    from repro_torch.kernels.kd_kl import ref as kd_ref

    gen = torch.Generator(device=dev).manual_seed(7)
    lt = torch.randn(8, 32, 10, device=dev, generator=gen) * 2
    ls = torch.randn(8, 32, 10, device=dev, generator=gen) * 2
    g = torch.randn(8, 32, device=dev, generator=gen)
    before = dict(LAUNCHES)
    kl = vmap(lambda a, b: kd_ops.kd_kl_loss(a, b))(lt, ls)
    dls = vmap(grad(lambda b, a, w: torch.sum(kd_ops.kd_kl_loss(a, b) * w)))(
        ls, lt, g)
    launched = {k: LAUNCHES[k] - before[k] for k in ("kd_kl_fwd", "kd_kl_bwd")}
    kl_ref, lse_t, lse_s = kd_ref.kd_kl_fwd_ref(lt.reshape(-1, 10),
                                                ls.reshape(-1, 10), 1.0)
    err_f = compare("vmap kd_kl_fwd", kl.reshape(-1), kl_ref)
    err_b = compare("vmap(grad) kd_kl_bwd", dls.reshape(-1, 10),
                    kd_ref.kd_kl_bwd_ref(lt.reshape(-1, 10),
                                         ls.reshape(-1, 10), lse_t, lse_s,
                                         g.reshape(-1), 1.0))
    if launched != {"kd_kl_fwd": 2, "kd_kl_bwd": 1}:
        raise AssertionError(f"B1/B2 under vmap: one launch for all 8 "
                             f"clients expected, got {launched}")
    log(f"  vmap rules: B1 under vmap over 8 x (32, 10) err {err_f:.2e}, B2 "
        f"under vmap(grad) err {err_b:.2e}, launches {launched}")
    for name, h, cin, cout, kk, s in (RESNET8_CONVS[3], RESNET8_CONVS[7]):
        x = torch.randn(4, 64, h, h, cin, device=dev, generator=gen)
        w = torch.randn(4, kk, kk, cin, cout, device=dev,
                        generator=gen) / math.sqrt(kk * kk * cin)
        oh = conv_ref.same_pads(h, kk, s)[0]
        dy = torch.randn(4, 64, oh, oh, cout, device=dev, generator=gen)

        def one(xi, wi, dyi):
            return torch.sum(conv_ops.client_batched_conv(
                xi[None], wi[None], stride=s)[0] * dyi)

        before = LAUNCHES["grouped_conv_fwd"]
        y = vmap(lambda xi, wi: conv_ops.client_batched_conv(
            xi[None], wi[None], stride=s)[0])(x, w)
        dx, dw = vmap(grad(one, argnums=(0, 1)))(x, w, dy)
        launched = LAUNCHES["grouped_conv_fwd"] - before
        errs = [compare(f"vmap conv {name}", y,
                        conv_ref.grouped_conv_ref(x, w, s, "SAME")),
                compare(f"vmap(grad) conv dx {name}", dx,
                        conv_ref.grouped_conv_dx(dy, w, s, h, h, "SAME")),
                compare(f"vmap(grad) conv dw {name}", dw,
                        conv_ref.shift_gemm_dw(x, dy, s, kk, kk, "SAME"))]
        if launched != 2:
            raise AssertionError(f"B3 under vmap {name}: one K=4 launch a "
                                 f"call expected, got {launched} for 2")
        log(f"  vmap rules: B3 under vmap over K=4 at {name} err y "
            f"{errs[0]:.2e} dx {errs[1]:.2e} dw {errs[2]:.2e}, launches "
            f"{launched}")


def check_flash(dev, teacher_ns: list[int]) -> dict:
    """Flash attention at the text path's shapes — (64, 64, 4, 4, 32)
    causal for a local step and its inline teacher forward, (256, ...) for
    an evaluation batch — and for coverage at (n, ...) for ``teacher_ns``,
    the row counts of a per-shard teacher pass (``precompute=True`` on the
    sequential executor), and at ``FLASH_COVERAGE``.  The record's times
    are the local step's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(2)
    path = [(n, 64, 4, 4, 32, True, None)
            for n in dict.fromkeys([64, 256] + teacher_ns)]
    rec = dict(max_abs_err=0.0)
    for b, s, hq, hkv, d, causal, window in path + FLASH_COVERAGE:
        q = torch.randn(b, s, hq, d, device=dev, generator=gen)
        k = torch.randn(b, s, hkv, d, device=dev, generator=gen)
        v = torch.randn(b, s, hkv, d, device=dev, generator=gen)
        shape = f"(B={b}, S={s}, Hq={hq}, Hkv={hkv}, D={d}, causal={causal}, window={window})"
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        err = compare(f"flash_attention_fwd {shape}",
                      ops.flash_attention_fwd(q, k, v, causal, window), want)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if (b, s) not in ((64, 64), (256, 64)) or window is not None:
            log(f"  flash {shape} err {err:.2e}")
            continue
        # the library yardstick on (B, H, S, D) copies made outside the
        # timed region; the port never calls it
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        compare(f"library sdpa {shape}", library().transpose(1, 2), want)
        t = dict(ms=time_ms(lambda: ops.flash_attention_fwd(q, k, v, causal)),
                 plain_ms=time_ms(lambda: ref.attention_ref(q, k, v,
                                                            causal=causal)),
                 library_ms=time_ms(library))
        # bytes: q, k, v read once (k, v at Hkv heads), o written once;
        # operations: 4·D per unmasked (query, key) pair and query head
        pairs = int(ref.causal_mask(s, s, device=dev).sum()) if causal else s * s
        nbytes = 4 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
        t.update(tf32x3_bound_ms(nbytes, 4 * d * pairs * b * hq))
        log(f"  flash {shape} err {err:.2e} kernel {t['ms']:.5f} ms plain "
            f"{t['plain_ms']:.5f} ms library {t['library_ms']:.5f} ms bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']}; fp32 "
            f"{t['fp32_bound_ms']:.5f})")
        if b == 64:                            # one local step's attention
            rec.update(t)
    return dict(name="flash_attention_fwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:28",
                **rec)


def ssd_inputs(dev, gen, b, l, h, p, g, n):
    """SSD scan inputs drawn as the Mamba-2 layer makes them at init:
    A = -(1..H); dt = softplus(z + dt_bias) with z ~ N(0, 1) and
    softplus(dt_bias) log-uniform on [1e-3, 1e-1]; x, B, C ~ N(0, 1),
    sliced from one (B, L, H·P + 2·G·N) tensor as ``mamba2_forward`` slices
    them from the conv output, so the kernel reads them at the path's
    strides."""
    import torch
    import torch.nn.functional as F

    dt0 = torch.exp(torch.rand(h, device=dev, generator=gen)
                    * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = F.softplus(torch.randn(b, l, h, device=dev, generator=gen) + dt_bias)
    a = -torch.arange(1, h + 1, device=dev, dtype=torch.float32)
    xbc = torch.randn(b, l, h * p + 2 * g * n, device=dev, generator=gen)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    bm = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
    cm = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    return x, dt, a, bm, cm


def ssd_cost(b, l, h, p, g, n, q) -> tuple[float, float]:
    """(bytes, FLOP) of one SSD scan: x, y, dt, A, B, C and the final state
    once each.  Per chunk of r rows, over its r(r+1)/2 pairs i >= j:
    2·pairs·N for C·Bᵀ once per (batch, B/C group), since every head of a
    group shares it (the function needs it once, whatever implements it);
    per (batch, head) 2·pairs·P for the weighted x, plus 2·r·N·P each for
    C·Sᵀ and the state update."""
    nbytes = 4 * (2 * b * l * h * p + b * l * h + h + 2 * b * l * g * n
                  + b * h * p * n)
    flops = 0.0
    for c0 in range(0, l, q):
        r = min(q, l - c0)
        pairs = r * (r + 1) // 2
        flops += g * 2 * pairs * n + h * (2 * pairs * p + 4 * r * n * p)
    return nbytes, flops * b


def check_ssd(dev, round_check_len: int) -> dict:
    """B5 against its plain version at the LM path's shapes (a step's batch,
    the evaluation batch, the card-vs-CPU round check's one sequence) and
    at ``SSD_COVERAGE``: y and the final state.  At each shape the gate is
    ``KERNEL_TOL`` of max|plain|; where that fails the plain version runs in
    float64 as well, and the kernel must then be no further from float64
    than the fp32 plain version is.  The record's times are a step's."""
    import torch

    from repro_torch.kernels.ssd_scan import ops, ref

    gen = torch.Generator(device=dev).manual_seed(5)
    h, p, g, n, q = 80, 64, 1, 128, 256
    path = [(LM_BATCH, LM_SEQ - 1, h, p, g, n, q),
            (LM_EVAL_BATCH, LM_SEQ - 1, h, p, g, n, q),
            (1, round_check_len, h, p, g, n, min(q, round_check_len))]
    rec = dict(max_abs_err=0.0)
    for shape in path + SSD_COVERAGE:
        b, l, h_, p_, g_, n_, q_ = shape
        args = ssd_inputs(dev, gen, b, l, h_, p_, g_, n_)
        got = ops.ssd_scan_fwd(*args, q_)
        want = ref.ssd_scan_ref(*args, q_)
        errs, gate = [], "plain"
        for name, a, w in zip(("y", "state"), got, want):
            err = float((a - w).abs().max())
            scale = float(w.abs().max())
            if not err <= KERNEL_TOL * max(scale, 1e-30):
                gate = "float64"
            errs.append(err)
        line = (f"  ssd {shape} err y {errs[0]:.3e} state {errs[1]:.3e} "
                f"(max|plain| {float(want[0].abs().max()):.3e}, "
                f"{float(want[1].abs().max()):.3e})")
        if gate == "float64" or shape in path[:1]:
            exact = ref.ssd_chunked(*(t.double() for t in args), chunk=q_)
            for name, a, w, e in zip(("y", "state"), got, want, exact):
                ek = float((a.double() - e).abs().max())
                ep = float((w.double() - e).abs().max())
                line += f"; {name} vs float64: kernel {ek:.3e} plain {ep:.3e}"
                if gate == "float64" and not ek <= ep:
                    raise AssertionError(
                        f"ssd_scan_fwd {shape}: {name} exceeds {KERNEL_TOL} x "
                        f"max|plain| and is further from float64 ({ek:.3e}) "
                        f"than the fp32 plain version ({ep:.3e})")
            line += f"; gate {gate}"
        rec["max_abs_err"] = max(rec["max_abs_err"], *errs)
        if shape == path[0]:
            t = dict(ms=time_ms(lambda: ops.ssd_scan_fwd(*args, q_), reps=5,
                                replays=4),
                     plain_ms=time_ms(lambda: ref.ssd_scan_ref(*args, q_),
                                      reps=5, replays=4),
                     library_ms=None)
            t.update(tf32x3_bound_ms(*ssd_cost(*shape)))
            plan = ops.ssd_plan(*shape)
            line += (f"; kernel {t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms"
                     f" bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
                     f"3xTF32; fp32 {t['fp32_bound_ms']:.4f}); grids "
                     f"{plan.grid} (chunk, pass, out), shared bytes "
                     f"{plan.chunk_smem} / {plan.out_smem}")
            rec.update(t)
        log(line)
    # the three launches' blocks grow with the batch: the time against the
    # batch shows how they fill the card's SMs
    sweep = []
    for b in SSD_SWEEP_BATCHES:
        args = ssd_inputs(dev, gen, b, LM_SEQ - 1, h, p, g, n)
        ms = time_ms(lambda: ops.ssd_scan_fwd(*args, q), reps=5, replays=4)
        grid = ops.ssd_plan(b, LM_SEQ - 1, h, p, g, n, q).grid
        sweep.append(f"B={b} ({grid[2]} output blocks) {ms:.4f} ms")
    log(f"  ssd time against batch at (B, 1023, 80, 64, 1, 128, 256): "
        + ", ".join(sweep))
    return dict(name="ssd_scan_fwd", route="cuda",
                source="src/repro_torch/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan/kernel.py:25", **rec)


def check_row_lse(dev) -> dict:
    """B6 against its plain version at the LM path's (4092, V) of a step and
    (8184, V) of an evaluation, V = 50,280, and at ``ROW_LSE_COVERAGE``;
    times the kernel, the plain version and ``torch.logsumexp(l / T, -1)``
    at the step's shape."""
    import torch

    from repro_torch.kernels.kd_kl import ops, ref

    gen = torch.Generator(device=dev).manual_seed(6)
    rows = LM_BATCH * (LM_SEQ - 1)
    path = [(rows, LM_VOCAB), (2 * rows, LM_VOCAB)]
    rec = dict(max_abs_err=0.0)
    for t_rows, vocab in path + ROW_LSE_COVERAGE:
        for temp in (1.0, 2.0):
            logits = torch.randn(t_rows, vocab, device=dev, generator=gen) * 3
            want = ref.row_logsumexp_ref(logits, temp)
            err = compare(f"row_logsumexp ({t_rows}, {vocab}) T={temp}",
                          ops.row_lse_fwd(logits, temp), want)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if (t_rows, vocab) != path[0] or temp != 1.0:
                log(f"  row_lse ({t_rows}, {vocab}) T={temp} err {err:.2e}")
                continue

            def library():
                return torch.logsumexp(logits / temp, -1)

            compare("library logsumexp", library(), want)
            t = dict(ms=time_ms(lambda: ops.row_lse_fwd(logits, temp)),
                     plain_ms=time_ms(lambda: ref.row_logsumexp_ref(logits, temp)),
                     library_ms=time_ms(library))
            # bytes: the logits read once, the row vector written; operations:
            # ~4 per element (scale, compare, exp, add)
            t["bound_ms"], t["bound_by"] = bound_ms(
                4 * t_rows * vocab + 4 * t_rows, 4 * t_rows * vocab)
            log(f"  row_lse ({t_rows}, {vocab}) T={temp} err {err:.2e} kernel "
                f"{t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms library "
                f"{t['library_ms']:.4f} ms bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']})")
            rec.update(t)
    return dict(name="row_logsumexp", route="cuda",
                source="src/repro_torch/csrc/kd_kl.cu",
                replaces="src/repro/kernels/kd_kl/kernel.py:148", **rec)


def all_finite(tree) -> bool:
    import torch

    from repro_torch.tree import tree_leaves

    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree))


def _range_kernels(event) -> dict:
    """Device kernels launched inside a profiler range: name -> (us, n)."""
    out: dict = {}
    stack = [event]
    while stack:
        e = stack.pop()
        for k in e.kernels:
            t, n = out.get(k.name, (0.0, 0))
            out[k.name] = (t + k.duration, n + 1)
        stack.extend(e.cpu_children)
    return out


def profile_round(dev, label, run, algo: str = "FedGKD") -> dict:
    """Where a steady-state round of ``algo`` goes: round 2 of a 2-round
    run under ``torch.profiler``, its host wall time, the device's busy
    time (the union of its kernels' and copies' intervals), and the device
    time by kernel name; then the device time inside each of the port's
    named ranges (``PORT_RANGES``), with its kernels by name.
    ``run(round_callback)`` drives the 2 rounds and calls
    ``round_callback(round, ...)`` after each round's synchronize.  Prints
    "not measured" where the profiler saw no device activity.  Returns
    ``wall_ms``, ``busy_ms`` and ``ranges`` (name -> device ms), empty
    where nothing was measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wall = {}

    def window(rnd, *_):
        if rnd == 1:
            # nothing of round 1 (an async refill) runs into the window
            torch.cuda.synchronize(dev)
            prof.start()
            wall["t0"] = time.perf_counter()
        elif rnd == 2:
            torch.cuda.synchronize(dev)
            wall["ms"] = (time.perf_counter() - wall["t0"]) * 1e3
            prof.stop()

    run(window)
    # device activity: kernels and copies, not the named ranges that the
    # profiler also draws on the device's timeline
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        log(f"profile ({label}, {algo} round 2): wall {wall['ms']:.3f} ms; "
            f"device busy time not measured (the profiler saw no device "
            f"activity)")
        return {}
    busy_us, end, by_name = 0.0, -math.inf, {}
    for lo, hi, name in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + hi - lo, n + 1)
    log(f"profile ({label}, {algo} round 2): wall {wall['ms']:.3f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms, idle share "
        f"{1 - busy_us / 1e3 / wall['ms']:.4f}, {len(spans)} device ops")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for rank, (name, (t, n)) in enumerate(ranked):
        # the top 12, and below them every hand-written kernel of the port
        if rank < 12 or any(k in name for k in PORT_KERNELS):
            log(f"  {t / 1e3:8.3f} ms {n:5d}x  {name[:90]}")
    # the device time of the kernels launched inside the port's named ranges
    ranges = [e for e in prof.events() if e.name in PORT_RANGES
              and e.device_type == torch.autograd.DeviceType.CPU]
    out = dict(wall_ms=wall["ms"], busy_ms=busy_us / 1e3, ranges={})
    for name in PORT_RANGES:
        hits = [e for e in ranges if e.name == name]
        if not hits:
            continue
        out["ranges"][name] = sum(e.device_time_total for e in hits) / 1e3
        log(f"  {out['ranges'][name]:8.3f} ms {len(hits):5d}x  range {name} "
            f"(all kernels inside it)")
        kernels: dict = {}
        for e in hits:
            for k, (t, n) in _range_kernels(e).items():
                t0, n0 = kernels.get(k, (0.0, 0))
                kernels[k] = (t0 + t, n0 + n)
        for k, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:4]:
            log(f"      {t / 1e3:8.3f} ms {n:5d}x  {k[:86]}")
    return out


def resnet_setup():
    """The ResNet-8 path's task, data and ``run_federated`` arguments: full
    width; depth cut to 4,500 examples, 1 local epoch, 5 batches per
    client, 3 rounds (the paper: 45,000, 20 epochs, 100 rounds)."""
    from repro_torch.configs.paper import CIFAR10, scaled
    from repro_torch.core import fl_loop

    task = scaled(CIFAR10, 0.1, rounds=3, local_epochs=1)
    data = fl_loop.make_federated_data(task, alpha=0.5, seed=0)
    return task, data, dict(seed=0, max_batches_per_client=5, width=16)


def text_setup():
    """The text path's task, data and ``run_federated`` arguments: the
    encoder at the repo's full width; depth cut to 3,000 examples, 5
    batches per client, 3 rounds (the paper: 60,000 and 10 rounds)."""
    from repro_torch.configs.paper import AG_NEWS, scaled
    from repro_torch.core import fl_loop

    task = scaled(AG_NEWS, 0.05, rounds=3)
    data = fl_loop.make_federated_data(task, alpha=0.5, seed=0)
    return task, data, dict(seed=0, max_batches_per_client=5)


def teacher_chunks(task, data, kw, stacked: bool) -> list[int]:
    """The row counts of round 1's teacher-precompute calls, in chunks of
    ``PRECOMPUTE_CHUNK`` (full chunks and ragged remainders), for the
    cohort that ``kw["seed"]`` draws: one call over its K·N_max rows when the
    executor stacks the cohort (``stacked``), one per client's shard
    otherwise."""
    import numpy as np

    from repro_torch.core.executor import PRECOMPUTE_CHUNK

    k = max(1, int(round(task.participation * data.n_clients)))
    cohort = data.sample_cohort(np.random.default_rng(kw["seed"]), k)
    ns = [data.clients[int(c)].n for c in cohort]
    rows = [k * max(ns)] if stacked else ns
    sizes = {min(PRECOMPUTE_CHUNK, r) for r in rows} | {
        r % PRECOMPUTE_CHUNK for r in rows}
    return sorted(sizes - {0}, reverse=True)


def first_round_check(dev, label, lr, params_after) -> None:
    """Round 1 on the card and on the CPU from the same init: the
    parameters must agree to ``ROUND_TOL`` while the round moved them by at
    least ``MIN_MOVE`` times that, so a card that trained wrongly, or not
    at all, fails.  ``params_after(device, rounds)`` runs that many rounds
    from the seed's init and returns the parameters as numpy leaves."""

    def max_diff(xs, ys):
        return max(float(abs(a - b).max()) for a, b in zip(xs, ys, strict=True))

    init, card = params_after("cpu", 0), params_after(dev, 1)
    t0 = time.perf_counter()
    cpu = params_after("cpu", 1)
    diff, moved = max_diff(cpu, card), max_diff(card, init)
    log(f"{label}: first round at lr {lr:g}, card vs CPU "
        f"({time.perf_counter() - t0:.1f} s on the CPU): max abs param diff "
        f"{diff:.3e} (limit {ROUND_TOL}); the round moved them by up to "
        f"{moved:.3e} (at least {MIN_MOVE * ROUND_TOL:g} required)")
    if not moved >= MIN_MOVE * ROUND_TOL:
        raise AssertionError(f"{label}: round 1 moved the params only {moved}, "
                             f"too little for the card-vs-CPU check")
    if not diff < ROUND_TOL:
        raise AssertionError(f"{label}: card and CPU disagree after one round: "
                             f"{diff}")


def run_path(dev, label, task, data, kw, kernels: list[str],
             check_lr=None) -> dict:
    """FedGKD for ``task.rounds`` rounds with the launch counts set to 0
    just before and read just after (every name in ``kernels`` must have
    launched), one FedAvg round, a profiled round, and round 1 on the card
    against the CPU's (at ``check_lr`` where given).  Returns the launch
    counts."""
    from repro_torch.core import algorithms, fl_loop
    from repro_torch.kernels import LAUNCHES, reset_launches

    def fedgkd():
        return algorithms.make("fedgkd", gamma=task.gamma,
                               buffer_m=task.buffer_m)

    reset_launches()
    t0 = time.perf_counter()
    hist = fl_loop.run_federated(task, fedgkd(), data, device=dev, **kw)
    launches = dict(LAUNCHES)
    log(f"{label}: FedGKD, {hist.telemetry}, "
        f"{time.perf_counter() - t0:.2f} s, launches {launches}")
    for r in hist.records:
        log(f"  round {r.round}: {r.seconds:.3f} s test_acc {r.test_acc:.4f} "
            f"test_loss {r.test_loss:.4f} local_loss {r.mean_local_loss:.4f} "
            f"cohort {list(r.sampled)}")
    losses = [v for r in hist.records for v in (r.test_loss, r.mean_local_loss)]
    if not (all(map(math.isfinite, losses)) and all_finite(hist.final_params)):
        raise AssertionError(f"{label} FedGKD: non-finite loss or params {losses}")
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {label} path: {missing}")

    h_avg = fl_loop.run_federated(task, algorithms.make("fedavg"), data,
                                  device=dev, rounds=1, **kw)
    r = h_avg.records[0]
    log(f"{label}: FedAvg round 1 {r.seconds:.3f} s test_acc {r.test_acc:.4f} "
        f"local_loss {r.mean_local_loss:.4f}")
    if not (math.isfinite(r.mean_local_loss) and all_finite(h_avg.final_params)):
        raise AssertionError(f"{label} FedAvg: non-finite loss or params")
    profile_round(dev, label, lambda cb: fl_loop.run_federated(
        task, fedgkd(), data, device=dev, rounds=2, round_callback=cb, **kw))
    check_task = (task if check_lr is None
                  else dataclasses.replace(task, lr=check_lr))
    federated_round_check(dev, label, check_task, data, kw, fedgkd)
    return launches


def federated_round_check(dev, label, task, data, kw, make_algo) -> None:
    """``first_round_check`` of ``run_federated`` with the algorithm that
    ``make_algo()`` builds (a fresh one for each run)."""
    from repro_torch.bridge import params_to_numpy
    from repro_torch.core import fl_loop
    from repro_torch.tree import tree_leaves

    def params_after(device, rounds):
        hist = fl_loop.run_federated(task, make_algo(), data, device=device,
                                     rounds=rounds, **kw)
        return tree_leaves(params_to_numpy(hist.final_params))

    first_round_check(dev, label, task.lr, params_after)


def baseline_specs(task, kw) -> list[tuple]:
    """The paper's baselines on the ResNet-8 path: (label, algorithm, its
    arguments beyond the reference's defaults, the executor ``"auto"`` must
    pick, the kernels that must launch).  The KD methods take the task's γ
    and M; SCAFFOLD the task's lr and the run's steps per client."""
    kd = dict(gamma=task.gamma, buffer_m=task.buffer_m)
    conv = ["grouped_conv_fwd"]
    kl = conv + ["kd_kl_fwd", "kd_kl_bwd"]
    scaffold = dict(lr=task.lr, local_steps_hint=kw["max_batches_per_client"])
    return [("fedprox", "fedprox", {}, "vmap", conv),
            ("fedgkd (mse)", "fedgkd", dict(kd, loss_type="mse"), "vmap",
             conv),
            ("fedgkd-vote", "fedgkd-vote", kd, "vmap", conv),
            ("fedgkd+", "fedgkd+", kd, "vmap", kl),
            ("moon", "moon", {}, "sequential", conv),
            ("feddistill+", "feddistill+", {}, "sequential", kl),
            ("scaffold", "scaffold", scaffold, "sequential", conv),
            ("feddyn", "feddyn", {}, "sequential", conv),
            ("fedgen", "fedgen", {}, "sequential", conv)]


def run_baselines(dev) -> dict:
    """The nine baselines at full ResNet-8 width (``resnet_setup``), each
    for ``BASELINE_ROUNDS`` rounds with ``executor="auto"`` and the launch
    counts set to 0 just before and read just after: the route must be
    the expected one, losses and params finite, and the kernels of its
    step launched; then round 1 on the card against the CPU's.  Last, a
    profiled steady-state round of MOON and of FedGen.  Returns the launch counts summed
    over the nine runs."""
    from repro_torch.core import algorithms, fl_loop
    from repro_torch.kernels import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    task, data, kw = resnet_setup()
    total = dict.fromkeys(LAUNCHES, 0)
    for label, name, args, route, kernels in baseline_specs(task, kw):
        def make_algo(name=name, args=args):
            return algorithms.make(name, **args)

        reset_launches()
        t0 = time.perf_counter()
        hist = fl_loop.run_federated(task, make_algo(), data, device=dev,
                                     rounds=BASELINE_ROUNDS, **kw)
        launches = dict(LAUNCHES)
        log(f"baseline {label}: route {hist.telemetry['route']}, "
            f"{time.perf_counter() - t0:.2f} s, launches {launches}")
        for r in hist.records:
            log(f"  round {r.round}: {r.seconds:.3f} s test_acc "
                f"{r.test_acc:.4f} test_loss {r.test_loss:.4f} local_loss "
                f"{r.mean_local_loss:.4f}")
        if hist.telemetry["route"] != route:
            raise AssertionError(f"baseline {label}: executor "
                                 f"{hist.telemetry['route']}, expected {route}")
        losses = [v for r in hist.records
                  for v in (r.test_loss, r.mean_local_loss)]
        if not (all(map(math.isfinite, losses))
                and all_finite(hist.final_params)):
            raise AssertionError(f"baseline {label}: non-finite loss or "
                                 f"params {losses}")
        missing = [k for k in kernels if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched by baseline {label}: "
                                 f"{missing}")
        for k, n in launches.items():
            total[k] += n
        federated_round_check(dev, f"ResNet-8 {label}", task, data, kw,
                              make_algo)
    # MOON: the sequential route's costliest step; FedGen: its default
    # noise reads the label sum and distribution back on every step
    for name, algo in (("moon", "MOON"), ("fedgen", "FedGen")):
        profile_round(dev, "ResNet-8", lambda cb, name=name:
                      fl_loop.run_federated(
                          task, algorithms.make(name), data, device=dev,
                          rounds=2, round_callback=cb, **kw), algo=algo)
    log(f"baselines phase: {time.perf_counter() - t_phase:.1f} s")
    return total


def resnet50_setup():
    """The ResNet-50 path's task, data and ``run_federated`` arguments:
    Tiny-ImageNet at the paper's settings (200 classes, 64x64 images, 20
    clients at C=0.2 so K=4, batch 64, gamma 0.1, M=5) and ResNet-50 at
    full width; depth cut to 9,000 examples, 1 local epoch, 5 batches per
    client, 3 rounds (the paper: 90,000, 20 epochs, 30 rounds)."""
    from repro_torch.configs.paper import TINY_IMAGENET, scaled
    from repro_torch.core import fl_loop

    task = scaled(TINY_IMAGENET, 0.1, rounds=R50_ROUNDS, local_epochs=1)
    data = fl_loop.make_federated_data(task, alpha=0.5, seed=0)
    return task, data, dict(seed=0, max_batches_per_client=5)


def run_resnet50(dev, task, data, kw) -> dict:
    """FedGKD on Tiny-ImageNet with ResNet-50 at full width through
    ``run_federated(executor="auto")``: the client-batched vmap route, with
    the launch counts set to 0 just before and read just after (B3 and
    B1/B2 must have launched), finite losses and params, the peak device
    memory, a profiled round 2 (the conv weight gradient's share of the
    busy time) and round 1 on the card against the CPU's at
    ``R50_CHECK_LR``.  Returns the launch counts."""
    import torch

    from repro_torch.core import algorithms, fl_loop
    from repro_torch.kernels import LAUNCHES, reset_launches

    label = "ResNet-50 Tiny-ImageNet"

    def fedgkd():
        return algorithms.make("fedgkd", gamma=task.gamma,
                               buffer_m=task.buffer_m)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    hist = fl_loop.run_federated(task, fedgkd(), data, device=dev,
                                 executor="auto", **kw)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"{label}: FedGKD, {hist.telemetry}, {time.perf_counter() - t0:.2f} "
        f"s, launches {launches}, peak device memory {peak:.2f} GiB")
    for r in hist.records:
        log(f"  round {r.round}: {r.seconds:.3f} s test_acc {r.test_acc:.4f} "
            f"test_loss {r.test_loss:.4f} local_loss {r.mean_local_loss:.4f} "
            f"cohort {list(r.sampled)}")
    if (hist.telemetry["route"], hist.telemetry["round_body"]) != (
            "vmap", "client_batched"):
        raise AssertionError(f"{label}: took {hist.telemetry}, not the "
                             f"client-batched vmap route")
    losses = [v for r in hist.records for v in (r.test_loss, r.mean_local_loss)]
    if not (all(map(math.isfinite, losses)) and all_finite(hist.final_params)):
        raise AssertionError(f"{label}: non-finite loss or params {losses}")
    missing = [k for k in ("grouped_conv_fwd", "kd_kl_fwd", "kd_kl_bwd")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {label} path: "
                             f"{missing}")
    del hist
    prof = profile_round(dev, label, lambda cb: fl_loop.run_federated(
        task, fedgkd(), data, device=dev, rounds=2, round_callback=cb, **kw))
    if prof:
        dw = prof["ranges"].get("grouped_conv_dw", 0.0)
        dx = prof["ranges"].get("grouped_conv_dx", 0.0)
        log(f"{label} round 2: {prof['wall_ms'] / 1e3:.3f} s, idle share "
            f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f}, peak "
            f"{peak:.2f} GiB; the conv weight gradient {dw:.3f} ms "
            f"({dw / prof['busy_ms']:.4f} of busy), the input gradient "
            f"{dx:.3f} ms ({dx / prof['busy_ms']:.4f})")
    federated_round_check(dev, label,
                          dataclasses.replace(task, lr=R50_CHECK_LR), data,
                          kw, fedgkd)
    return launches


def run_vmap_body(dev) -> dict:
    """The vmapped round body: the TOY task's MLP through
    ``executor="vmap"`` for ``VMAP_ROUNDS`` rounds of FedGKD (B1/B2 under
    ``torch.func.vmap``) and of the five algorithms with client hooks
    (their finalize and state update vmapped too), each with the launch
    counts set to 0 just before and read just after, then round 1 on the
    card against the CPU's; and ResNet-8 FedGKD with
    ``client_batched=False`` (B3 and B1/B2 under vmap) for one round,
    held against the client-batched route's round to ``VMAP_TOL``.
    Returns the launch counts summed over the runs."""
    from repro_torch.bridge import params_to_numpy
    from repro_torch.configs.paper import TOY
    from repro_torch.core import algorithms, fl_loop
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    data = fl_loop.make_federated_data(TOY, alpha=1.0, seed=0, n_test=400)
    kw = dict(seed=0, executor="vmap")
    total = dict.fromkeys(LAUNCHES, 0)
    for name in VMAP_ALGOS:
        def make_algo(name=name):
            return algorithms.make(name)

        reset_launches()
        hist = fl_loop.run_federated(TOY, make_algo(), data, device=dev,
                                     rounds=VMAP_ROUNDS, **kw)
        launches = dict(LAUNCHES)
        log(f"vmapped body TOY {name}: {hist.telemetry}, rounds "
            f"{[round(r.seconds, 3) for r in hist.records]} s, test_acc "
            f"{[round(r.test_acc, 4) for r in hist.records]}, launches "
            f"{ {k: n for k, n in launches.items() if n} }")
        if hist.telemetry.get("round_body") != "vmap":
            raise AssertionError(f"TOY {name}: {hist.telemetry}, not the "
                                 f"vmapped body")
        losses = [v for r in hist.records
                  for v in (r.test_loss, r.mean_local_loss)]
        if not (all(map(math.isfinite, losses))
                and all_finite(hist.final_params)):
            raise AssertionError(f"TOY {name}: non-finite loss or params")
        if name in ("fedgkd", "feddistill+") and not (
                launches["kd_kl_fwd"] and launches["kd_kl_bwd"]):
            raise AssertionError(f"TOY {name}: B1/B2 not launched under vmap")
        for k, n in launches.items():
            total[k] += n
        federated_round_check(dev, f"TOY {name} (vmapped body)", TOY, data,
                              kw, make_algo)

    task, data, kw = resnet_setup()
    out = {}
    for body, flag in (("vmap", False), ("client_batched", "auto")):
        reset_launches()
        hist = fl_loop.run_federated(
            task, algorithms.make("fedgkd", gamma=task.gamma,
                                  buffer_m=task.buffer_m),
            data, device=dev, rounds=1, client_batched=flag, **kw)
        launches = dict(LAUNCHES)
        log(f"ResNet-8 FedGKD, {body} body: {hist.records[0].seconds:.3f} s, "
            f"local_loss {hist.records[0].mean_local_loss:.6f}, launches "
            f"{ {k: n for k, n in launches.items() if n} }")
        if hist.telemetry["round_body"] != body:
            raise AssertionError(f"ResNet-8 client_batched={flag}: "
                                 f"{hist.telemetry}")
        missing = [k for k in ("grouped_conv_fwd", "kd_kl_fwd", "kd_kl_bwd")
                   if launches[k] == 0]
        if missing:
            raise AssertionError(f"ResNet-8 {body} body: not launched "
                                 f"{missing}")
        if body == "vmap":
            for k, n in launches.items():
                total[k] += n
        out[body] = tree_leaves(params_to_numpy(hist.final_params))
    diff = max(float(abs(a - b).max())
               for a, b in zip(out["vmap"], out["client_batched"], strict=True))
    log(f"ResNet-8 FedGKD round 1: vmapped body against client-batched, max "
        f"abs param diff {diff:.3e} (limit {VMAP_TOL})")
    if not diff < VMAP_TOL:
        raise AssertionError(f"ResNet-8: the vmapped body is {diff} from the "
                             f"client-batched one")
    log(f"vmapped-body phase: {time.perf_counter() - t_phase:.1f} s")
    return total


def async_executor(pipelined: bool = True):
    """The resilience phase's buffered-async executor: B=2 of the K=4
    cohort, the fedgkd staleness scheme (cutoff 4), a straggler quarter 4x
    slower, availability windows of 80% of a 24-unit period, the vmap
    executor training each wave."""
    from repro_torch.core import executor, systemsim

    return executor.AsyncExecutor(
        buffer_size=2, staleness="fedgkd", staleness_cutoff=4,
        profile=systemsim.SpeedProfile(kind="straggler", straggler_frac=0.25,
                                       straggler_slowdown=4.0),
        availability=systemsim.Availability(period=24.0, duty=0.8),
        inner="vmap", pipelined=pipelined)


def capture_round(rnd: int, into: dict):
    """A ``round_callback`` that keeps the global after round ``rnd`` as
    numpy leaves in ``into["params"]``."""
    from repro_torch.bridge import params_to_numpy
    from repro_torch.tree import tree_leaves

    def cb(t, server, model):
        if t == rnd:
            into["params"] = tree_leaves(params_to_numpy(server["global"]))
    return cb


def assert_same_history(label, a, b) -> float:
    """Records equal field by field (``REC_FIELDS``); returns the final
    params' max abs difference, which the caller gates."""
    if len(a.records) != len(b.records):
        raise AssertionError(f"{label}: {len(a.records)} against "
                             f"{len(b.records)} records")
    for ra, rb in zip(a.records, b.records):
        for f in REC_FIELDS:
            if getattr(ra, f) != getattr(rb, f):
                raise AssertionError(f"{label}: record {ra.round} differs in "
                                     f"{f}: {getattr(ra, f)!r} against "
                                     f"{getattr(rb, f)!r}")
    return params_diff(a.final_params, b.final_params)


@contextlib.contextmanager
def record_shapes():
    """Record the shapes that B1, B2 and B3's wrappers are called with on
    the card while the block runs: yields {wrapper name: set of (argument
    shapes, constants)}; the wrappers are put back on exit."""
    from repro_torch.kernels.grouped_conv import ops as conv_ops
    from repro_torch.kernels.kd_kl import ops as kd_ops

    seen = {"grouped_conv_fwd": set(), "kd_kl_fwd": set(), "kd_kl_bwd": set()}
    keys = {"grouped_conv_fwd": lambda x, w, stride, padding: (
                tuple(x.shape), tuple(w.shape), stride, padding),
            "kd_kl_fwd": lambda lt, ls, temp: (tuple(lt.shape), temp),
            "kd_kl_bwd": lambda lt, ls, lse_t, lse_s, g, temp: (
                tuple(lt.shape), temp)}
    wrapped = [(conv_ops, "grouped_conv_fwd"), (kd_ops, "kd_kl_fwd"),
               (kd_ops, "kd_kl_bwd")]
    originals = [getattr(mod, name) for mod, name in wrapped]

    def recorder(name, fn):
        def call(*args, **kwargs):
            if args[0].is_cuda:
                seen[name].add(keys[name](*args, **kwargs))
            return fn(*args, **kwargs)
        return call

    for (mod, name), fn in zip(wrapped, originals):
        setattr(mod, name, recorder(name, fn))
    try:
        yield seen
    finally:
        for (mod, name), fn in zip(wrapped, originals):
            setattr(mod, name, fn)


def check_path_shapes(dev, seen: dict) -> dict:
    """B1, B2 and B3 against their plain versions, untimed, at every
    distinct shape that ``record_shapes`` saw (the async waves' and the
    retried subsets' K = 1-3 steps and their teacher chunks among them),
    on random inputs.  Returns each kernel's max abs error."""
    import torch

    from repro_torch.kernels.grouped_conv import ops as conv_ops
    from repro_torch.kernels.grouped_conv import ref as conv_ref
    from repro_torch.kernels.kd_kl import ops as kd_ops
    from repro_torch.kernels.kd_kl import ref as kd_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    err = dict.fromkeys(seen, 0.0)
    for xs, ws, stride, padding in sorted(seen["grouped_conv_fwd"]):
        x = torch.randn(xs, device=dev, generator=gen)
        w = torch.randn(ws, device=dev, generator=gen) / math.sqrt(
            ws[1] * ws[2] * ws[3])
        err["grouped_conv_fwd"] = max(err["grouped_conv_fwd"], compare(
            f"grouped_conv x{xs} w{ws} stride {stride}",
            conv_ops.grouped_conv_fwd(x, w, stride, padding),
            conv_ref.grouped_conv_ref(x, w, stride, padding)))
    for (rows, vocab), temp in sorted(seen["kd_kl_fwd"] | seen["kd_kl_bwd"]):
        lt = torch.randn(rows, vocab, device=dev, generator=gen) * 2
        ls = torch.randn(rows, vocab, device=dev, generator=gen) * 2
        g = torch.randn(rows, device=dev, generator=gen)
        kl, lse_t, lse_s = kd_ops.kd_kl_fwd(lt, ls, temp)
        want = kd_ref.kd_kl_fwd_ref(lt, ls, temp)
        err["kd_kl_fwd"] = max([err["kd_kl_fwd"]] + [
            compare(f"kd_kl_fwd{(rows, vocab)} T={temp}:{n}", a, b)
            for n, a, b in zip(("kl", "lse_t", "lse_s"),
                               (kl, lse_t, lse_s), want)])
        err["kd_kl_bwd"] = max(err["kd_kl_bwd"], compare(
            f"kd_kl_bwd{(rows, vocab)} T={temp}",
            kd_ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, temp),
            kd_ref.kd_kl_bwd_ref(lt, ls, lse_t, lse_s, g, temp)))
    conv_kn = sorted({xs[:2] for xs, *_ in seen["grouped_conv_fwd"]})
    kd_rows = sorted({key[0] for key in seen["kd_kl_fwd"] | seen["kd_kl_bwd"]})
    log(f"resilience path shapes against their plain versions: B3 at "
        f"{len(seen['grouped_conv_fwd'])} shapes, (K, N) in {conv_kn}; B1/B2 "
        f"at {kd_rows}; max abs err {err}")
    return err


def run_resilience(dev) -> tuple[dict, dict]:
    """``resilience_runs`` with the shapes of B1, B2 and B3 recorded, then
    each kernel checked against its plain version at every one of them
    (``check_path_shapes``).  Returns the launch counts of the card runs
    and each kernel's max abs error."""
    with record_shapes() as seen:
        total = resilience_runs(dev)
    return total, check_path_shapes(dev, seen)


def resilience_runs(dev) -> dict:
    """The resilience layer at full ResNet-8 width (``resnet_setup``: 20
    clients, K=4, batch 64, 5 batches a client), FedGKD throughout, each
    card run with the launch counts set to 0 just before and read just
    after (B1, B2 and B3 must launch):

      1. DP (``RES_DP``), 2 rounds: every clipped delta's norm within
         ``clip_norm`` (1 + 1e-5), and round 1 against the CPU's;
      2. faults (``RES_CHAOS``), 3 rounds: the fault counters equal the
         CPU run's, round 1 against the CPU's;
      3. kill and resume: 4 rounds checkpointed every round, a callback
         raising after round 2, then ``resume=True``, against the
         uninterrupted run: equal records, the params' max abs difference
         printed and gated at 0; the checkpoint writes timed;
      4. async (``async_executor``), 6 aggregations: ``sim_time``,
         ``version``, ``mean_staleness`` and ``sampled`` equal the CPU
         run's, aggregation 1's global against the CPU's, pipelined against
         single-stream within ``PIPE_TOL``, seconds per aggregation of both
         (aggregations 2-6, the card synchronised at the start); then the
         same run under ``RES_CHAOS`` killed after aggregation 3 and
         resumed, against its uninterrupted run as in 3;
      5. a profiled steady-state aggregation (the second), pipelined and
         not: wall, busy, idle share, the kernels' launches; then, in a
         run of its own each (so that no profile carries the debug mode's
         cost), the host synchronisations of aggregation 2
         (``torch.cuda.set_sync_debug_mode("warn")``), by line.

    Returns the launch counts summed over the card runs."""
    import tempfile
    import traceback
    import warnings

    import torch

    from repro_torch.checkpoint import recovery
    from repro_torch.core import algorithms, fl_loop, privacy, systemsim
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    task, data, kw = resnet_setup()
    total = dict.fromkeys(LAUNCHES, 0)
    path_kernels = ("kd_kl_fwd", "kd_kl_bwd", "grouped_conv_fwd")

    def fedgkd():
        return algorithms.make("fedgkd", gamma=task.gamma,
                               buffer_m=task.buffer_m)

    def on_cpu(**run_kw):
        return fl_loop.run_federated(task, fedgkd(), data, device="cpu",
                                     **{**kw, **run_kw})

    def drive(label, **run_kw):
        reset_launches()
        t0 = time.perf_counter()
        hist = fl_loop.run_federated(task, fedgkd(), data, device=dev,
                                     **{**kw, **run_kw})
        launches = dict(LAUNCHES)
        log(f"resilience {label}: {time.perf_counter() - t0:.2f} s, launches "
            f"{ {k: n for k, n in launches.items() if n} }")
        for r in hist.records:
            log(f"  round {r.round}: {r.seconds:.3f} s test_acc "
                f"{r.test_acc:.4f} local_loss {r.mean_local_loss:.4f} "
                f"sim_time {r.sim_time!r} version {r.version} staleness "
                f"{r.mean_staleness} sampled {list(r.sampled)}")
        losses = [v for r in hist.records
                  for v in (r.test_loss, r.mean_local_loss)]
        if not (all(map(math.isfinite, losses))
                and all_finite(hist.final_params)):
            raise AssertionError(f"resilience {label}: non-finite loss or "
                                 f"params {losses}")
        missing = [k for k in path_kernels if launches[k] == 0]
        if missing:
            raise AssertionError(f"resilience {label}: not launched "
                                 f"{missing}")
        for k, n in launches.items():
            total[k] += n
        return hist

    def round_one(label, card: dict, cpu: dict) -> None:
        init = on_cpu(rounds=0)
        leaves = {("cpu", 0): tree_leaves_np(init.final_params),
                  (str(dev), 1): card["params"], ("cpu", 1): cpu["params"]}
        first_round_check(dev, label, task.lr,
                          lambda device, rounds: leaves[(str(device), rounds)])

    # 1. DP: the clipped deltas' norms, read where the loop clips
    dp = privacy.DPConfig(**RES_DP)
    norms = {"raw": [], "clipped": []}
    clip = privacy.privatize_uploads

    def clip_and_measure(uploads, anchor, dp_, t):
        out = clip(uploads, anchor, dp_, t)
        for key, ups in (("raw", uploads), ("clipped", out)):
            norms[key] += [float(global_norm(tree_map(
                lambda a, b: a.float() - b.float(), u["params"], anchor)))
                for u in ups]
        return out

    card = {}
    privacy.privatize_uploads = clip_and_measure
    try:
        drive("DP", rounds=RES_DP_ROUNDS, dp=dp,
              round_callback=capture_round(1, card))
    finally:
        privacy.privatize_uploads = clip
    log(f"resilience DP: delta norms before clipping {norms['raw']}, after "
        f"{norms['clipped']} (clip_norm {dp.clip_norm})")
    if not max(norms["clipped"]) <= dp.clip_norm * (1 + 1e-5):
        raise AssertionError(f"DP: a clipped delta's norm "
                             f"{max(norms['clipped'])} > {dp.clip_norm}")
    cpu = {}
    on_cpu(rounds=1, dp=dp, round_callback=capture_round(1, cpu))
    round_one("ResNet-8 FedGKD under DP", card, cpu)

    # 2. faults: the counters depend on the fault stream and the gate only
    chaos = systemsim.FaultProfile(**RES_CHAOS)
    card, cpu = {}, {}
    t0 = time.perf_counter()
    h_card = drive("faults", rounds=RES_FAULT_ROUNDS, faults=chaos,
                   round_callback=capture_round(1, card))
    fault_s = time.perf_counter() - t0
    h_cpu = on_cpu(rounds=RES_FAULT_ROUNDS, faults=chaos,
                   round_callback=capture_round(1, cpu))
    log(f"resilience faults: card {h_card.telemetry['faults']}; CPU "
        f"{h_cpu.telemetry['faults']}")
    if h_card.telemetry["faults"] != h_cpu.telemetry["faults"]:
        raise AssertionError("faults: the card's counters differ from the "
                             "CPU's")
    round_one("ResNet-8 FedGKD under CHAOS faults", card, cpu)
    t0 = time.perf_counter()
    drive("no faults (the faulted rounds' yardstick)",
          rounds=RES_FAULT_ROUNDS)
    log(f"resilience faults: {RES_FAULT_ROUNDS} faulted rounds "
        f"{fault_s:.3f} s, unfaulted {time.perf_counter() - t0:.3f} s "
        f"(host wall of the run, init and evaluation included)")

    # 3. kill and resume, with the checkpoint writes timed
    class Killed(Exception):
        pass

    def kill_after(rnd):
        def cb(t, *_):
            if t == rnd:
                raise Killed
        return cb

    writes = []
    save = recovery.save_run_state

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        path = save(*args, **kwargs)
        writes.append((time.perf_counter() - t0, Path(path).stat().st_size))
        return path

    def kill_and_resume(label, rounds, kill_at, **run_kw):
        full = drive(f"{label}, uninterrupted", rounds=rounds, **run_kw)
        with tempfile.TemporaryDirectory() as ck:
            recovery.save_run_state = timed_save
            try:
                try:
                    drive(f"{label}, killed after {kill_at}", rounds=rounds,
                          checkpoint_dir=ck, round_callback=kill_after(kill_at),
                          **run_kw)
                except Killed:
                    pass
                else:
                    raise AssertionError(f"{label}: the run was not killed")
            finally:
                recovery.save_run_state = save
            resumed = drive(f"{label}, resumed", rounds=rounds,
                            checkpoint_dir=ck, resume=True, **run_kw)
        diff = assert_same_history(label, full, resumed)
        log(f"resilience {label}: resumed against uninterrupted, records "
            f"equal, max abs param diff {diff!r}; checkpoint writes "
            f"{[f'{s * 1e3:.3f} ms / {b} B' for s, b in writes]}")
        if diff != 0.0:
            raise AssertionError(f"{label}: the resumed run is {diff} from "
                                 f"the uninterrupted one")
        writes.clear()

    kill_and_resume("kill and resume", RES_KILL_ROUNDS, 2)

    # 4. async: the virtual clock against the CPU's, pipelined against
    # single-stream, seconds per aggregation
    def timed_async(into: dict, capture: dict):
        first = capture_round(1, capture)

        def cb(t, *args):
            first(t, *args)
            if t == 1:
                torch.cuda.synchronize(dev)
                into["t1"] = time.perf_counter()
            elif t == RES_AGGS:
                into["s"] = (time.perf_counter() - into["t1"]) / (RES_AGGS - 1)
        return cb

    runs, card, cpu = {}, {}, {}
    hists = {}
    for pipelined in (True, False):
        runs[pipelined] = {}
        hists[pipelined] = drive(
            f"async, pipelined={pipelined}", rounds=RES_AGGS,
            executor=async_executor(pipelined),
            round_callback=timed_async(runs[pipelined],
                                       card if pipelined else {}))
    h_cpu = on_cpu(rounds=RES_AGGS, executor=async_executor(),
                   round_callback=capture_round(1, cpu))
    for rt, rc in zip(hists[True].records, h_cpu.records, strict=True):
        for f in ("round", "sim_time", "version", "mean_staleness",
                  "sampled"):
            if getattr(rt, f) != getattr(rc, f):
                raise AssertionError(f"async: aggregation {rt.round}'s {f} "
                                     f"{getattr(rt, f)!r} on the card, "
                                     f"{getattr(rc, f)!r} on the CPU")
    log(f"resilience async: telemetry {hists[True].telemetry}")
    round_one("ResNet-8 FedGKD async, aggregation 1", card, cpu)
    pipe = max(abs(getattr(a, f) - getattr(b, f))
               for a, b in zip(hists[True].records, hists[False].records)
               for f in ("test_acc", "test_loss", "mean_local_loss"))
    pipe = max(pipe, params_diff(hists[True].final_params,
                                 hists[False].final_params))
    log(f"resilience async: pipelined against single-stream, max abs diff "
        f"{pipe:.3e} (limit {PIPE_TOL}); seconds per aggregation (2-{RES_AGGS}"
        f") pipelined {runs[True]['s']:.6f}, single-stream "
        f"{runs[False]['s']:.6f}")
    if not pipe < PIPE_TOL:
        raise AssertionError(f"async: pipelined is {pipe} from single-stream")
    kill_and_resume("async under CHAOS faults, kill and resume", RES_AGGS, 3,
                    executor=async_executor(), faults=chaos)

    # 5. a steady-state aggregation, profiled, pipelined and not; its host
    # syncs counted in an unprofiled run of each mode
    def count_syncs(pipelined) -> dict:
        syncs: dict = {}

        def window(t, *_):
            if t == 1:
                torch.cuda.synchronize(dev)
                torch.cuda.set_sync_debug_mode("warn")
            elif t == 2:
                torch.cuda.set_sync_debug_mode(0)

        def record(message, *_args, **_kw):
            # attributed to the innermost frame of the port or this
            # script, with its function's name
            if "synchroniz" not in str(message):
                return
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "repro_torch" in f.filename
                      or f.filename.endswith("chip_smoke.py")]
            f = frames[-1]
            where = f"{Path(f.filename).name}:{f.lineno} {f.name}"
            syncs[where] = syncs.get(where, 0) + 1

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            try:
                fl_loop.run_federated(task, fedgkd(), data, device=dev,
                                      rounds=3, round_callback=window,
                                      executor=async_executor(pipelined),
                                      **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return syncs

    for pipelined in (True, False):
        counts = {}

        def run(cb, pipelined=pipelined):
            def window(t, *args):
                if t == 2:
                    counts["end"] = dict(LAUNCHES)
                cb(t, *args)
                if t == 1:
                    counts["start"] = dict(LAUNCHES)

            fl_loop.run_federated(task, fedgkd(), data, device=dev, rounds=3,
                                  round_callback=window,
                                  executor=async_executor(pipelined), **kw)

        label = (f"ResNet-8 async B=2 "
                 f"({'pipelined' if pipelined else 'single-stream'})")
        prof = profile_round(dev, label, run, algo="FedGKD aggregation")
        launched = {k: counts["end"][k] - counts["start"][k]
                    for k in path_kernels}
        if prof:
            log(f"{label}, aggregation 2: {prof['wall_ms'] / 1e3:.6f} s, busy "
                f"{prof['busy_ms'] / 1e3:.6f} s, idle share "
                f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f}, launches "
                f"{launched}")
        syncs = count_syncs(pipelined)
        log(f"{label}: host synchronisations in aggregation 2 (a run without "
            f"the profiler), by line: "
            f"{sorted(syncs.items(), key=lambda kv: -kv[1])} "
            f"({sum(syncs.values())} in all)")
    log(f"resilience phase: {time.perf_counter() - t_phase:.1f} s")
    return total


def tree_leaves_np(params) -> list:
    from repro_torch.bridge import params_to_numpy
    from repro_torch.tree import tree_leaves

    return tree_leaves(params_to_numpy(params))


def params_diff(a, b) -> float:
    """The max abs difference of two params trees."""
    return max(float(abs(x - y).max()) for x, y in zip(
        tree_leaves_np(a), tree_leaves_np(b), strict=True))


def lm_config(n_layers: int):
    """mamba2-2.7b at its published width, depth cut to ``n_layers``, in
    fp32 (the port's kernels are fp32; bf16 is later work)."""
    from repro_torch.configs import get_config

    return get_config(LM_ARCH).replace(n_layers=n_layers,
                                       param_dtype="float32",
                                       activation_dtype="float32")


def run_lm_path(dev) -> dict:
    """The federated LM trainer (``launch.train.run_serial``) on mamba2-2.7b
    at full width: FedGKD for ``LM_ROUNDS`` rounds with the launch counts
    set to 0 just before and read just after (every kernel of the path must
    have launched, and the teacher's KD term must be non-zero in some
    round), one FedAvg round, a profiled round, and round 1 on the card
    against the CPU's at ``LM_CHECK``'s size.  Returns the launch
    counts."""
    import torch

    from repro_torch.bridge import params_to_numpy
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import run_serial
    from repro_torch.tree import tree_leaves

    cfg = lm_config(LM_LAYERS)
    label = f"{LM_ARCH} LM"
    log(f"{label}: d_model {cfg.d_model}, {cfg.n_layers} layers, vocab "
        f"{cfg.vocab_size}, {tuple(cfg.ssm)}, remat {cfg.remat}, "
        f"{cfg.param_count():,} params; {LM_RUN}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    out = run_serial(cfg, rounds=LM_ROUNDS, algo="fedgkd", device=dev,
                     verbose=False, straggler_frac=LM_STRAGGLER_FRAC,
                     **LM_RUN)
    launches = dict(LAUNCHES)
    log(f"{label}: FedGKD, {time.perf_counter() - t0:.2f} s, launches "
        f"{launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    for r in out["history"]:
        log(f"  round {r['round']}: {r['seconds']:.3f} s ppl {r['ppl']:.6g} "
            f"(eval CE {math.log(r['ppl']):.6f}) loss {r['loss']:.6f} "
            f"kd {r['kd']:.6e} sim_seconds {r['sim_seconds']!r}")
    values = [v for r in out["history"] for v in (r["ppl"], r["loss"], r["kd"])]
    if not (all(map(math.isfinite, values)) and all_finite(out["params"])):
        raise AssertionError(f"{label} FedGKD: non-finite ppl, loss or params "
                             f"{values}")
    missing = [k for k in LM_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {label} path: {missing}")
    if not any(r["kd"] > 0 for r in out["history"]):
        raise AssertionError(f"{label} FedGKD: the KD term is 0 in every round, "
                             f"so the teacher never entered the loss")
    del out

    avg = run_serial(cfg, rounds=1, algo="fedavg", device=dev, verbose=False,
                     **LM_RUN)
    r = avg["history"][0]
    log(f"{label}: FedAvg round 1 {r['seconds']:.3f} s ppl {r['ppl']:.6g} "
        f"loss {r['loss']:.6f}")
    if not (math.isfinite(r["ppl"]) and math.isfinite(r["loss"])
            and all_finite(avg["params"])):
        raise AssertionError(f"{label} FedAvg: non-finite ppl, loss or params")
    del avg
    profile_round(dev, label, lambda cb: run_serial(
        cfg, rounds=2, algo="fedgkd", device=dev, verbose=False,
        round_callback=cb, **LM_RUN))

    check_cfg = lm_config(1)

    def params_after(device, rounds):
        out = run_serial(check_cfg, rounds=rounds, algo="fedgkd",
                         device=device, verbose=False, **LM_CHECK)
        for r in out["history"]:
            log(f"  round check, {device}: round {r['round']} loss "
                f"{r['loss']:.6f} kd {r['kd']:.6e}")
        return tree_leaves(params_to_numpy(out["params"]))

    first_round_check(dev, f"{label} (1 layer, {LM_CHECK['n_clients']} "
                      f"clients x {LM_CHECK['batches_per_round']} batches of "
                      f"{LM_CHECK['batch']} x {LM_CHECK['seq']} tokens)",
                      LM_CHECK["lr"], params_after)
    return launches


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port is not at {SRC / 'repro_torch'}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    # every plain version and library call below is an fp32 reference:
    # TF32 (about 3 digits) would swamp the comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {build.BUILD_LOG['path']}")
    for line in build.BUILD_LOG["ptxas"].splitlines():
        if line.startswith("=="):
            log("  " + line.strip())
        elif "Compiling entry" in line:           # the kernel's mangled name
            log("    " + line.split("'")[1])
        elif "Used" in line or "spill" in line:
            log("      " + line.split(":", 1)[-1].strip())

    resnet = resnet_setup()
    text = text_setup()
    r50 = resnet50_setup()
    conv_chunks = teacher_chunks(*resnet, stacked=True)
    text_chunks = teacher_chunks(*text, stacked=False)
    r50_chunks = teacher_chunks(*r50, stacked=True)
    log(f"kernels against their plain versions (fp32, TF32 off; device "
        f"time of CUDA-graph replays); teacher chunks of round 1: ResNet-8 "
        f"{conv_chunks}, ResNet-50 {r50_chunks}; text (a per-shard pass, "
        f"for coverage) {text_chunks}")
    kernels = (check_kd_kl(dev) + [check_conv(dev, conv_chunks, r50_chunks),
                                   check_flash(dev, text_chunks),
                                   check_ssd(dev, LM_CHECK["seq"] - 1),
                                   check_row_lse(dev)])
    check_vmap_rules(dev)
    launches = [
        run_path(dev, "ResNet-8", *resnet,
                 ["kd_kl_fwd", "kd_kl_bwd", "grouped_conv_fwd"]),
        run_path(dev, "AG News text", *text,
                 ["flash_attention_fwd", "kd_kl_fwd", "kd_kl_bwd"],
                 check_lr=TEXT_CHECK_LR),
        run_lm_path(dev),
        run_baselines(dev),
        run_resnet50(dev, *r50),
        run_vmap_body(dev)]
    resilience_counts, resilience_errs = run_resilience(dev)
    launches.append(resilience_counts)
    for k in kernels:
        k["launches"] = sum(counts[k["name"]] for counts in launches)
        k["max_abs_err"] = max(k["max_abs_err"],
                               resilience_errs.get(k["name"], 0.0))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build "
        f"included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
