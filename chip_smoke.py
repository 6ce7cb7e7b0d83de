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
     FedDistill+'s (64, 10), the population phase's K=64 TOY cohort under
     vmap (1024, 10), (256, 100), (256, 200), a ragged (1000, 37),
     the text path's (64, 4) and (64, 5), the LM path's (4092, 50280),
     the MoE phase's (2048, 32000) and (64, 256206) with both bases one
     element past a 16-byte boundary; each with its share of its bound;
     the client-batched conv at all 9 ResNet-8 layers at K=4, N=64, at
     K=1, N=64 (the sequential route's step), at K=2 and K=3, N=64 (the
     async loop's refill waves and the fault-tolerant round's retried
     subsets), at K=1, N=256 and at K=1
     with the teacher precompute's chunk sizes, and at ResNet-50's 23
     distinct shapes at 64x64 (53 convs) at K=4, N=64 and at K=1 with
     N=256 and the teacher's chunk sizes; the conv's weight gradient at
     ResNet-8's convs at K = 1-4, N = 64 and at ResNet-50's shapes at K=4,
     N=64, against cuDNN's as well (``check_conv_dw``); flash attention at the text
     path's (B, S, Hq, Hkv, D) = (64, 64, 4, 4, 32) of a local step and
     a teacher forward, (256, ...) of an evaluation batch, and for
     coverage at the row counts a per-shard teacher pass would take, GQA
     with a window, non-causal ragged S = 100 at D = 128, and S = 1; the SSD scan at the LM path's
     (B, L, H, P, G, N, chunk) = (4, 1023, 80, 64, 1, 128, 256) of a step,
     (8, ...) of an evaluation and (1, 512, ...) of the round check, and
     for coverage at the smoke config's layer, two groups at a ragged
     length, L = 1, one 4,096-token sequence, one full-width chunk, a
     chunk of 48 and P, N not multiples of 4; the row logsumexp at
     (4092, 50280), (8184, 50280), (2048, 32000), one and two rows and
     ragged shapes —
     to 1e-5 of the plain version's largest magnitude (fp32, TF32 off;
     for the SSD scan and the conv's weight gradient, where the fp32 plain
     version is itself further than that from float64, to being no further
     from float64 than the plain version, ``nearer_float64``), and times
     the kernel,
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
     (of the forward, of the weight gradient) for all the vmapped clients;
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
     h. the population tier (``run_population``, ``run_federated(
        population=)``): a million registered synthetic clients (the
        reference's population bench: 245 shards, warm cap 256), the
        sampler's K=64 draw timed against a 10k-client control (within
        2x), and FedGKD on the TOY task's MLP for 3 rounds of K=64 through
        the vmap executor (B1/B2 under vmap), its cohorts and tier
        counters equal to a CPU run's, the warm tier within its cap, the
        cold loads within the cohorts and the probe client; the run again
        in a child process started before phase a., after a 10k-client
        run of the same task: its peak RSS before and after and the bytes
        its warm tier holds;
        ResNet-8 at full width from disk shards (warm cap 4),
        with a one-shard sampler equal to the ``data=`` run within 1e-6
        and with 4 shards evicting; FedDyn (the sequential route) with its
        states spilled to disk and reloaded, equal to the ``data=`` run
        within 1e-6; the async run of g. with ``population=``, killed after
        aggregation 3 and resumed, bitwise, with no pin left; B1-B3 then
        held to their plain versions at every shape these runs gave them;
     i. multi-host placement (``run_multihost``): h.'s ResNet-8 disk
        shards placed over two host processes on the one card (fresh
        interpreters, ``--multihost-child``), each owning 2 shards,
        FedGKD at K=4: the hosts bitwise equal to each other (params,
        accuracies, gathered telemetry) and within 1e-5 of the one-host
        run; under host crashes and CHAOS faults the hosts bitwise and
        their counters equal to their CPU run's; host 1 killed after
        round 2 of 4 and both resumed, bitwise equal to the uninterrupted
        run; the async run, bitwise between hosts, its clock and buffers
        the one-host run's; two ranks of ``python -m
        repro_torch.launch.distributed`` on gloo; in this process the
        shard_map executor with two slices on the card at K=4 and K=3 (a
        phantom client) against the vmap executor; the round walls of 2
        hosts and 1, each host's publish and gather ms and round-2 idle
        share; B1-B3 launched in every host and held to their plain
        versions at the shapes the hosts and slices gave them;
     j. the LM serve path (``run_serve``), every model at its published
        width in fp32: phi4-mini-3.8b (depth 32 -> 2) through one FedGKD
        round of ``run_serial`` (2 clients x 1 batch of 2 x 1,024 tokens,
        M = 3; B4, B6, B1/B2 at V = 200,064; its peak device memory under
        70 GiB), a prefill of the last position (4 x 1,024), then from a
        fresh init ``ServeLoop`` (8 requests in waves of 4, prompts of
        4-12 tokens, 16 generated; tokens/s) and the sliding-window ring
        buffer (window cut to 64, 160 tokens) against the windowed
        forward; mamba2-2.7b (4 layers) and zamba2-1.2b (depth 38 -> 6,
        one shared-block application; a prefill, B5 and B4) through
        ``ServeLoop``; minitron-4b, granite-34b and internlm2-20b at depth
        1; each architecture's greedy decode against its teacher-forced
        forward within the reference's bar (2e-3 + 2e-3 |forward|), and
        each ``ServeLoop``'s tokens against the CPU's (phi4-mini's at 1
        layer), a difference passing only where the CPU's top-2 logit gap
        is below the card-vs-CPU logit difference; then B4 and B5 held to
        their plain versions at every shape the phase gave them, B5 from
        an entering state, and B6, B1 and B2 at (2,048, 200,064), each
        timed against its bound and a PyTorch call;
     k. the published dtype, bf16 (``run_bf16``): first the kernels' bf16
        forms against their plain versions on the same values upcast (B4
        at phi4-mini's (2, 1,024, 24/8, 128), zamba2's (4, 1,024, 32/32,
        64), the ring gate's window-64 shape and mixtral's (2, 1,024, 32/8,
        128) with its window of 4,096, its bf16 o
        within one bf16 ulp of the plain output rounded, and within the
        reference's 2e-2 of the bf16 plain version, which rounds P; B1 and
        B6 at the fp32 bar and B2's bf16 dls within one ulp, at (2,048,
        200,064) and (4,092, 50,280); B5's casting wrapper around its
        fp32 kernels at zamba2's prefill, timed as the wrapper's), each
        timed against its bound at 2 bytes an element (B4's at its bf16
        tensor-core arithmetic) and a PyTorch call (sdpa in bf16); then
        phi4-mini-3.8b at
        published width in bf16 with depth 32 -> 8 through two FedGKD
        rounds of ``run_serial`` (2 clients x 2 batches of 2 x 1,024
        tokens, M = 3, lr 0.1; B4's bf16 form, B6, B1/B2 launched; KD
        non-zero in round 2), the same in fp32, each with its peak memory
        and a profiled round; round 1 of the smoke config in bf16 on the
        card against the CPU's bf16 and fp32 rounds (the CPU tests' bar:
        no further from fp32 than twice the CPU's bf16 run, or one bf16
        ulp); phi4-mini unchanged (32 layers, bf16): a last-position
        prefill of 4 x 1,024, ``ServeLoop``, greedy decode over bf16 caches
        against a forward in fp32 under that bar, ``ServeLoop``'s tokens
        against the CPU's at 1 layer; mamba2-2.7b in bf16 at depth 4, one
        round of the LM path's run and a profiled round, and its smoke
        round 1 on the card against the CPU's under the same bar with one
        local step a client (two steps are read, not gated: the second
        amplifies the first's roundings, ROADMAP C); ``run_sharded``
        with two clients on the card, equal to ``run_serial`` with two;
     l. the MoE family (``run_moe``, the last phase): mixtral-8x7b at its
        published width in bf16 (8 experts of d_ff 14,336, top-2, capacity
        factor 1.25), depth 32 -> 2, through two FedGKD rounds of
        ``run_serial`` (phi4-mini's bf16 run: 2 clients x 2 batches of 2 x
        1,024 tokens, M = 3, lr 0.1; B4's bf16 form, B6, B1/B2 launched;
        KD non-zero in round 2; every load-balance loss > 0; the share of
        (token, choice) entries dropped by capacity; peak memory under 75
        GiB; a profiled round); depth 32 -> 8 for a prefill of 4 x 1,024
        and ``ServeLoop`` (tokens/s, a profiled second run); at depth 2 on
        a copy with a lossless capacity (E / top-k: at 1.25 a decode step
        of 4 tokens has 2 slots an expert and drops tokens the forward
        keeps, by design), greedy decode over bf16 caches against the
        forward in fp32 (``bf16_parity``), in fp32 against the forward at
        the reference's bar, and the window-64 ring over 160 tokens; round
        1 of the smoke config and of its DeepSeek-option variant (sigmoid
        router, a shared expert, a leading dense layer, MTP) on the card
        against the CPU's, in fp32 (1e-4) and in bf16 (``bf16_parity``);
     m. the last families (``run_families``, the last phase), each at its
        published width in bf16: deepseek-v3-671b (MLA of 128 heads, kv
        rank 512; 256 experts top-8, sigmoid router, a shared expert; MTP;
        vocab 129,280) at depth 61 -> 1 with first_k_dense 3 -> 1 (one
        dense MLA layer, the MoE run empty) through two FedGKD rounds of
        ``run_serial`` (the bf16 phase's 2 clients x 2 batches of 2 x
        1,024; B6, B1/B2 launched; KD non-zero in round 2; peak under 75
        GiB; a profiled round), depth 4 (3 dense + 1 MoE) for a prefill
        of 4 x 1,024 and ``ServeLoop`` over MLA caches (a profiled second
        run; the cache's bytes a token), a lossless copy at depth 2 for
        greedy decode against the forward (bf16 under ``bf16_parity``,
        fp32 at the reference's bar), its smoke round 1 against the CPU's
        in fp32 and bf16; seamless-m4t-large-v2 uncut (24 encoder + 24
        decoder layers, 1.37B) through two FedGKD rounds driven by
        ``launch.steps`` (``step_rounds``: 2 clients x 2 batches of 2 x
        1,024 tokens after 384 synthetic frames, the teacher the previous
        global, ``make_aggregate_step``), a prefill of the last position,
        greedy decode with the encoder's output against the forward (bf16
        and fp32); llava-next-34b at depth 60 -> 2 through two such rounds
        on 576 patches + 448 tokens, one ``cached_topk`` step (K = 64 from
        ``torch.topk`` of the teacher's logits), depth 8 for a prefill of
        4 x (576 + 448); the smoke rounds of seamless and llava through
        the steps on the card against the CPU's; then B4 (both forms: the
        encoder's bidirectional attention, cross-attention with Sq != Skv
        and in decode, a GQA group of 7), B1, B2 and B6 held to their
        plain versions at every shape the phase gave them, each timed
        against its bound and a PyTorch call (``check_family_kernels``);
     in phases k., l. and m., before their rounds, the dry-run's
     prediction held to the card (``step_peak_gate``): one FedGKD train
     step of the phase's batch (2 x 1,024 tokens) at its cut (phi4-mini
     depth 8, mixtral depth 2, deepseek-v3 depth 1) with params, teacher
     and optimizer state resident, its ``torch.cuda.max_memory_allocated``
     beyond them against ``launch.dryrun_lib``'s ``temp_size_in_bytes``
     for the same step traced on the meta device, the ratio within
     ``STEP_PEAK_BAND`` (0.85-1.15); its wall time beside the dry-run's
     bound and its model FLOPs' share of the bf16 peak, for the record;
     the bounds of every kernel check above come from
     ``launch.roofline``'s cost functions, and ``dispatch_cost`` times the
     host's cost of a B1 call through its ``repro_torch`` operator;
  5. profiles one steady-state round of each path (``torch.profiler``;
     FedGKD, MOON and FedGen for the baselines, an async aggregation
     pipelined and not, and a population round of the TOY and the
     disk-shard runs, each with its host synchronisations counted by
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
     says why; the TOY runs of phases f and h at the task's lr).

It exits non-zero on any failure.  The last lines of its output are the
kernels' JSON record, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# the H100's peaks, the kernels' cost functions and their bounds are
# repro_torch.launch.roofline's (imported where used, after the port is on
# the path): B1, B2 and B6 are fp32 on the CUDA cores; B3, B4 and B5 run
# their products in 3xTF32 on the tensor cores, three TF32 products for
# each fp32 one, so their bound counts 3 x FLOP at the TF32 peak (the fp32
# CUDA-core bound is printed beside it)
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
# the population phase (the reference's benchmarks/population_bench.py
# setting): 1M registered synthetic clients (8-24 rows each) in 245 shards
# of 4,096, a warm cap of 256, K=64 cohorts of the TOY task (batch 16, one
# local epoch, 3 rounds); the sampler's K=64 draw at 1M timed against a
# 10k-client control, within 2x; ResNet-8 from disk shards of 5 clients
# with a warm cap of 4; FedDyn's states with a state warm cap of 2
POP_CLIENTS, POP_K, POP_ROUNDS, POP_CONTROL = 1_000_000, 64, 3, 10_000
POP_SYNTH = dict(warm_cap=256, shard_size=4096, min_n=8, max_n=24, seed=0,
                 n_test=128)
POP_SAMPLE_REPS, POP_SAMPLE_RATIO = 200, 2.0
POP_DISK_SHARD, POP_DISK_WARM, POP_STATE_WARM = 5, 4, 2
POP_EQ_TOL = 1e-6          # population= against data= on the card
POP_KW = dict(seed=0, executor="vmap", width=16)
# the flag that runs ``population_footprint``'s child process
FOOTPRINT_FLAG = "--population-footprint"
# the multi-host phase (``run_multihost``): the population phase's ResNet-8
# disk shards over 2 host processes on the one card, FedGKD for 3 rounds,
# the fault and kill runs for 4 (host 1 killed after round 2), the async
# run for 4 aggregations; host crashes at 0.25 an attempt beside RES_CHAOS;
# a peer's deadline 120 s, the kill's survivor's 10 s (paid once)
MH_HOSTS, MH_ROUNDS, MH_KILL_ROUNDS, MH_AGGS = 2, 3, 4, 4
MH_HOST_CRASH = 0.25
MH_TIMEOUT_S, MH_KILL_TIMEOUT_S, MH_WAIT_S = 120.0, 10.0, 300.0
MH_TOL = 1e-5              # of the one-host run's max |param|
MH_CPU_BATCHES = 1         # the CPU fault run: its counters need no more
MULTIHOST_FLAG = "--multihost-child"
# what a resumed run must reproduce exactly
REC_FIELDS = ("round", "test_acc", "test_loss", "mean_local_loss",
              "sim_time", "version", "mean_staleness", "sampled")
# the MoE phase's (rows, vocab) of a step: mixtral-8x7b, 2 x 1,024 positions
MOE_KD = (2 * 1024, 32_000)
# B1/B2 (rows, vocab[, storage offset in elements]): the main path's, the
# LM's and the MoE phase's, and seamless-m4t's odd vocab with both bases
# one element past a 16-byte boundary (B1 peels a head before its 16-byte
# loads)
KD_SHAPES = [(256, 10), (64, 10), (128, 10), (192, 10), (1024, 10),
             (256, 100), (256, 200), (1000, 37), (64, 4), (64, 5),
             (4092, 50280), MOE_KD, (64, 256_206, 1)]
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
PORT_KERNELS = ["kd_kl_", "conv_fwd_kernel", "conv_dw_", "flash_fwd_kernel",
                "flash_fwd_bf16_kernel", "row_lse_",
                "ssd_chunk_kernel", "ssd_pass_kernel", "ssd_out_kernel"]
PORT_RANGES = ["ssd_scan_backward", "grouped_conv_dw", "grouped_conv_dx"]
# flash attention (B, S, Hq, Hkv, D, causal, window) beyond the text path's
# own: GQA with a window, non-causal ragged at D = 128, one token
FLASH_COVERAGE = [(4, 128, 8, 2, 64, True, 32), (8, 100, 4, 4, 128, False, None),
                  (64, 1, 4, 4, 32, True, None)]

# the serve phase (``run_serve``): phi4-mini-3.8b at its published width,
# depth 32 -> 2, one FedGKD round of run_serial (2 clients x 1 batch of 2
# sequences of 1,024 positions, M = 3; its peak device memory under 70 GiB),
# a prefill of the last position at 4 x 1,024, ServeLoop (8 requests in
# waves of 4, prompts of 4-12 tokens, 16 generated), the ring buffer with
# the window cut to 64 over 160 tokens; mamba2-2.7b at lm_config(4) and
# zamba2-1.2b at depth 38 -> 6 (one shared-block application) through
# ServeLoop (zamba2 also a prefill); minitron-4b, granite-34b and
# internlm2-20b at depth 1: greedy decode of 8 tokens after an 8-token
# prompt against the teacher-forced forward, within the reference's bar
SERVE_PHI_LAYERS, SERVE_ZAMBA_LAYERS = 2, 6
SERVE_FL = dict(n_clients=2, batches_per_round=1, batch=2, seq=1025,
                gamma=0.2, buffer_m=3, lr=0.1, seed=0)
SERVE_PEAK_GIB = 70.0
SERVE_PREFILL = (4, 1024)
SERVE_REQ = dict(requests=8, batch=4, prompt_len=12, gen=16)
SERVE_CHECK_BATCH, SERVE_DECODE_PROMPT, SERVE_DECODE_STEPS = 2, 8, 8
SERVE_WINDOW, SERVE_RING_TOKENS = 64, 160
# decode against forward: the reference's bar, |decode - forward| <= 2e-3 +
# 2e-3 |forward| (tests/test_arch_smoke.py:79, assert_allclose); at full
# width a tied head's logits reach ~3,000 (the input token's own embedding
# against itself, |e|^2 ~ d_model), where fp32 alone differs by ~1e-6 x that
DECODE_TOL = 2e-3
# B5 from an entering state at zamba2's width, and its timed prefill shape
# ((B, L, H, P), (B, L, G, N), chunk); B6 and B1/B2 at phi4-mini's vocabulary
# and a step's rows
SERVE_SSD_INIT = ((2, 300, 64, 64), (2, 300, 1, 64), 256)
SERVE_SSD_TIMED = ((4, 1024, 64, 64), (4, 1024, 1, 64), 256)
SERVE_KD_ROWS, SERVE_VOCAB = 2 * 1024, 200_064
SERVE_KERNELS = ["flash_attention_fwd", "ssd_scan_fwd", "row_logsumexp",
                 "kd_kl_fwd", "kd_kl_bwd"]

# the bf16 phase (``run_bf16``): the kernels' bf16 forms against their plain
# versions (B4 at phi4-mini's (B, S, Hq, Hkv, D) of a step, zamba2's shared
# block at its prefill, the ring gate's window; B1, B2 and B6 at phi4-mini's
# and mamba2's (rows, vocab) of a step; B5 through its casting wrapper at
# zamba2's prefill); phi4-mini at published width in bf16, depth 32 -> 8,
# two FedGKD rounds of run_serial (2 clients x 2 batches of 2 x 1,024
# tokens, M = 3) and the same in fp32; round 1 of the smoke config on the
# card against the CPU's; phi4-mini unchanged (32 layers) for inference;
# mamba2 at depth 4 for one round; run_sharded on the card twice over
BF16_FLASH = [(2, 1024, 24, 8, 128, None), (4, 1024, 32, 32, 64, None),
              (1, 160, 24, 8, 128, 64), (2, 1024, 32, 8, 128, 4096)]
BF16_KD = [(2 * 1024, 200_064), (LM_BATCH * (LM_SEQ - 1), LM_VOCAB)]
BF16_FLASH_TOL = 2e-2      # the reference's bf16 bar (P rounded to bf16)
BF16_PHI_LAYERS = 8
BF16_FL = dict(n_clients=2, batches_per_round=2, batch=2, seq=1025,
               gamma=0.2, buffer_m=3, lr=0.1, seed=0)
BF16_ROUNDS = 2
# round 1 of the smoke phi4-mini in bf16, card against CPU: 2 clients x 2
# batches of 2 x 128 positions
BF16_CHECK = dict(BF16_FL, seq=129)
# mamba2's, gated: one local step a client
BF16_MAMBA_CHECK = dict(BF16_CHECK, batches_per_round=1)
BF16_SHARDED = dict(rounds=1, batches_per_round=1, batch=2, seq=257,
                    lr=0.1, seed=0)
BF16_KERNELS = ["flash_attention_fwd_bf16", "row_logsumexp", "kd_kl_fwd",
                "kd_kl_bwd"]

# the MoE phase (``run_moe``): mixtral-8x7b (arXiv:2401.04088) at its
# published width in bf16 (d_model 4,096, 32/8 heads of 128, 8 experts of
# d_ff 14,336, top-2, vocab 32,000, window 4,096): depth 32 -> 2 through
# BF16_ROUNDS FedGKD rounds of BF16_FL (phi4-mini's bf16 run: 2 clients x 2
# batches of 2 x 1,024 tokens, M = 3, lr 0.1), its peak under
# MOE_PEAK_GIB; depth 32 -> 8 for a prefill of SERVE_PREFILL and
# ServeLoop; decode against the forward and the ring gate (window 64) at
# depth 2 on a copy with a lossless capacity (capacity_factor = E / top-k:
# with the published 1.25 a decode step of B = 4 tokens has 2 slots an
# expert, so decode drops tokens the forward keeps, by design); round 1 of
# the smoke config and of its DeepSeek-option variant on the card against
# the CPU's, in fp32 and in bf16
MOE_ARCH = "mixtral-8x7b"
MOE_TRAIN_LAYERS, MOE_SERVE_LAYERS, MOE_DECODE_LAYERS = 2, 8, 2
MOE_PEAK_GIB = 75.0
MOE_CHECK = dict(BF16_CHECK)       # 2 clients x 2 batches of 2 x 128

# the families' phase (``run_families``), every model at its published
# width in bf16: deepseek-v3-671b (arXiv:2412.19437; MLA of 128 heads, kv
# rank 512, 256 experts of d_ff 2,048 top-8 with a sigmoid router and a
# shared expert, 3 leading dense layers of d_ff 18,432, MTP, vocab 129,280)
# at depth 61 -> 1 with first_k_dense 3 -> 1 (one dense MLA layer, the MoE
# run empty: a MoE layer alone holds 11.3B parameters, so no round with one
# fits a card) through BF16_ROUNDS FedGKD rounds of BF16_FL, its peak under
# FAM_PEAK_GIB; depth 4 (3 dense + 1 MoE) for a prefill of SERVE_PREFILL and
# ServeLoop over MLA caches; a lossless copy at depth 2 (1 dense + 1 MoE) for
# decode against the forward; its smoke round 1 against the CPU's;
# seamless-m4t-large-v2 (arXiv:2308.11596) uncut (24 encoder + 24 decoder
# layers) and llava-next-34b (hf:llava-hf/llava-v1.6; 56/8 heads of 128) at
# depth 60 -> 2 through BF16_ROUNDS FedGKD rounds driven by the steps
# (``step_rounds``: FAM_FL, the teacher the previous global), seamless on
# 384 frames and a prefill and decode with the encoder's output, llava on
# 576 patches + 448 tokens, a cached_topk step and depth 8 for a prefill
DS_ARCH, SEAMLESS_ARCH, LLAVA_ARCH = ("deepseek-v3-671b",
                                      "seamless-m4t-large-v2",
                                      "llava-next-34b")
DS_TRAIN_LAYERS, DS_SERVE_LAYERS = 1, 4
LLAVA_TRAIN_LAYERS, LLAVA_SERVE_LAYERS = 2, 8
FAM_PEAK_GIB = 75.0
FAM_FL = dict(clients=2, batches=2, batch=2, seq=1024, gamma=0.2, lr=0.1)
FAM_TOPK = 64
DS_KERNELS = ["row_logsumexp", "kd_kl_fwd", "kd_kl_bwd"]   # MLA: no B4
# the step-peak gates (``step_peak_gate``): one FedGKD train step of the
# phase's own batch (BF16_FL's 2 sequences of 1,024 tokens) at the phase's
# cut, its device memory beyond the resident params, teacher and optimizer
# state held to the dry-run's prediction on the meta device
STEP_PEAK_BAND = (0.85, 1.15)
FAM_KERNELS = ["flash_attention_fwd_bf16", "row_logsumexp", "kd_kl_fwd",
               "kd_kl_bwd"]


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


def compare(name: str, got, want) -> float:
    """Max |got - want|; raises if it exceeds KERNEL_TOL·max|want|."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not math.isfinite(err) or err > KERNEL_TOL * max(scale, 1e-30):
        raise AssertionError(f"{name}: max abs err {err:.3e} exceeds "
                             f"{KERNEL_TOL} x max|plain| = {scale:.3e}")
    return err


def nearer_float64(name: str, got, plain, exact, always: bool = False):
    """``got`` against the fp32 plain version ``plain``: within KERNEL_TOL
    of max|plain|, or, where it is not, no further from the float64 result
    (``exact()``) than the plain version is (its own fp32 rounding can pass
    the bar).  Returns max|got - plain| and, where float64 was read (past
    the bar, or with ``always``), the two distances from it; raises where
    neither holds."""
    err = float((got - plain).abs().max())
    near = math.isfinite(err) and err <= KERNEL_TOL * max(
        float(plain.abs().max()), 1e-30)
    if near and not always:
        return err, None
    e = exact()
    ek, ep = (float((t.double() - e).abs().max()) for t in (got, plain))
    if not near and not ek <= ep:
        raise AssertionError(
            f"{name}: {err:.3e} from the plain version exceeds {KERNEL_TOL} "
            f"x max|plain| and it is further from float64 ({ek:.3e}) than "
            f"the fp32 plain version ({ep:.3e})")
    return err, (ek, ep)


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
    from repro_torch.launch import roofline as rl

    gen = torch.Generator(device=dev).manual_seed(0)
    temp = 1.0
    rec = {"kd_kl_fwd": {"max_abs_err": 0.0}, "kd_kl_bwd": {"max_abs_err": 0.0}}
    for line in ptxas_of("kd_kl_fwd"):      # B1's forms: registers, spills
        log(f"  ptxas: {line}")
    for rows, vocab, *offset in KD_SHAPES:
        off = offset[0] if offset else 0
        lt, ls = ((torch.randn(rows * vocab + off, device=dev, generator=gen)
                   * 2)[off:].view(rows, vocab) for _ in range(2))
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
        fwd = dict(ms=time_ms(lambda: ops.kd_kl_fwd(lt, ls, temp)),
                   plain_ms=time_ms(lambda: ref.kd_kl_fwd_ref(lt, ls, temp)),
                   library_ms=time_ms(library_fwd))
        fwd["bound_ms"], fwd["bound_by"] = rl.kd_kl_fwd_cost(rows,
                                                             vocab).bound()
        bwd = dict(ms=time_ms(lambda: ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, temp)),
                   plain_ms=time_ms(lambda: ref.kd_kl_bwd_ref(
                       lt, ls, lse_t, lse_s, g, temp)),
                   library_ms=None)
        bwd["bound_ms"], bwd["bound_by"] = rl.kd_kl_bwd_cost(rows,
                                                             vocab).bound()
        log(f"  kd_kl ({rows:4d},{vocab:3d}){f' offset {off}' if off else ''}"
            f" fwd err {err_f:.2e} "
            f"kernel {fwd['ms']:.5f} ms plain {fwd['plain_ms']:.5f} ms "
            f"library {fwd['library_ms']:.5f} ms bound {fwd['bound_ms']:.3g} "
            f"ms, {fwd['bound_ms'] / fwd['ms']:.3f} of it | bwd err "
            f"{err_b:.2e} kernel {bwd['ms']:.5f} ms plain "
            f"{bwd['plain_ms']:.5f} ms bound {bwd['bound_ms']:.3g} ms, "
            f"{bwd['bound_ms'] / bwd['ms']:.3f} of it")
        if (rows, vocab) == (256, 10):          # the CIFAR-10 main path
            rec["kd_kl_fwd"].update(fwd)
            rec["kd_kl_bwd"].update(bwd)
            log(f"  launch floor: an empty kernel {launch_floor_ms():.5f} ms "
                f"(CUDA-graph replays, as the kernels above)")
    dispatch_cost(dev)
    return [
        dict(name="kd_kl_fwd", route="cuda", source="src/repro_torch/csrc/kd_kl.cu",
             replaces="src/repro/kernels/kd_kl/kernel.py:33", **rec["kd_kl_fwd"]),
        dict(name="kd_kl_bwd", route="cuda", source="src/repro_torch/csrc/kd_kl.cu",
             replaces="src/repro/kernels/kd_kl/kernel.py:113", **rec["kd_kl_bwd"]),
    ]


def dispatch_cost(dev, calls: int = 2000) -> dict:
    """The host's time a call of B1 at the main path's (256, 10), where the
    host's time is the call's: through ``ops.kd_kl_fwd`` (its
    ``repro_torch::kd_kl_fwd`` operator) and through the launch function
    called directly, in turns (operator, direct, direct, operator), each
    the wall time of ``calls`` calls ending in a synchronize over the
    calls; the lower of each pair.  Returns the microseconds a call."""
    import torch

    from repro_torch.kernels.kd_kl import ops

    gen = torch.Generator(device=dev).manual_seed(4)
    lt, ls = (torch.randn(256, 10, device=dev, generator=gen)
              for _ in range(2))
    forms = {"operator": lambda: ops.kd_kl_fwd(lt, ls, 1.0),
             "direct": lambda: ops._kd_kl_fwd_cuda(lt, ls, 1.0)}
    us = {}
    for name in ("operator", "direct", "direct", "operator"):
        fn = forms[name]
        for _ in range(50):
            fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(dev)
        t = (time.perf_counter() - t0) / calls * 1e6
        us[name] = min(us.get(name, t), t)
    log(f"  host time a call of B1 at (256, 10): {us['operator']:.2f} us "
        f"through its operator, {us['direct']:.2f} us calling the launch "
        f"function directly: the operator's dispatch adds "
        f"{us['operator'] - us['direct']:.2f} us")
    return us


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
    from repro_torch.launch import roofline as rl

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
                nbytes, flops, _ = rl.grouped_conv_cost(k, n, h, cin, cout,
                                                        kk, s)
                t.update(rl.tf32x3_bound_ms(nbytes, flops))
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
        bound = rl.tf32x3_bound_ms(tot["nbytes"], tot["flops"])
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


def check_conv_dw(dev) -> dict:
    """B3's weight gradient (``grouped_conv_dw``) in five groups: ResNet-8's
    nine convs at K = 4, 3, 2 and 1, N = 64 (the client-batched route's
    step, the async waves and retried subsets, the sequential route's
    step) and ResNet-50's 23 distinct shapes at K=4, N=64 (its step, each
    shape as often as the network has it).  At each conv the kernel is
    held to ``shift_gemm_dw``, its first form and plain version, by
    ``nearer_float64`` (the plain version sums up to 65,536 terms a client
    in one fp32 chain: 1.5e-5 of max from float64 at the stem), launches
    once a call and gives the same bits twice.  The library yardstick is
    cuDNN's weight gradient (``torch.nn.grad.conv2d_weight``, ``groups=K``,
    on the inputs packed channel-wise and padded as JAX pads SAME, the
    packing not timed); it is timed, not held: the algorithm cuDNN picks at
    some 3x3 shapes lands 4x further from float64 than the plain version
    (its distance is printed).  Prints each conv's kernel, plain
    and cuDNN ms, its 3xTF32 bound from ``grouped_conv_dw_cost`` and its
    plan, and each group's totals with the shapes where the kernel is
    slower than the plain version or cuDNN; the record's times are the
    ResNet-8 K=4 step's, with the groups beside them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.grouped_conv import ops, ref
    from repro_torch.launch import roofline as rl

    gen = torch.Generator(device=dev).manual_seed(8)
    r8 = [c + (1,) for c in RESNET8_CONVS]
    groups = {f"K={k} step": (k, r8) for k in (4, 3, 2, 1)}
    groups["R50 K=4 step"] = (4, resnet50_shapes(R50_HW))
    slow = dict(reps=3, replays=2)      # the plain version: ms a call
    n = 64
    rec = dict(max_abs_err=0.0, groups={})
    for group, (k, convs) in groups.items():
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0,
                   flops=0.0, slower=[], slower_than_library=[])
        for name, h, cin, cout, kk, s, count in convs:
            oh, lo, hi = ref.same_pads(h, kk, s)
            x = torch.randn(k, n, h, h, cin, device=dev, generator=gen)
            dy = torch.randn(k, n, oh, oh, cout, device=dev, generator=gen)

            def kernel():
                return ops.grouped_conv_dw(x, dy, s, kk, kk, "SAME")

            def plain():
                return ref.shift_gemm_dw(x, dy, s, kk, kk, "SAME")

            exact = functools.cache(lambda: ref.shift_gemm_dw(
                x.double(), dy.double(), s, kk, kk, "SAME"))
            before = LAUNCHES["grouped_conv_dw"]
            got, again = kernel(), kernel()
            if LAUNCHES["grouped_conv_dw"] - before != 2:
                raise AssertionError(f"dw K={k} {name}: one launch a call "
                                     f"expected, got "
                                     f"{LAUNCHES['grouped_conv_dw'] - before}"
                                     f" for 2")
            if not torch.equal(got, again):
                raise AssertionError(f"dw K={k} {name}: two calls differ")
            want = plain()
            err, far = nearer_float64(f"grouped_conv_dw K={k} {name}", got,
                                      want, exact, always=name == "stem")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            xg = F.pad(x.permute(1, 0, 4, 2, 3).reshape(n, k * cin, h, h),
                       (lo, hi, lo, hi))
            dyg = dy.permute(1, 0, 4, 2, 3).reshape(n, k * cout, oh, oh)

            def library():
                return torch.nn.grad.conv2d_weight(
                    xg, (k * cout, cin, kk, kk), dyg, stride=s, groups=k)

            lib = library().reshape(k, cout, cin, kk, kk).permute(0, 3, 4, 2, 1)
            lib_err = float((lib - want).abs().max())
            lib64 = (float((lib.double() - exact()).abs().max()) if far
                     else None)
            del got, again, want, lib
            t = dict(ms=time_ms(kernel), plain_ms=time_ms(plain, **slow),
                     library_ms=time_ms(library, **slow))
            nbytes, flops, _ = rl.grouped_conv_dw_cost(k, n, h, h, cin, cout,
                                                       kk, kk, s)
            t.update(rl.tf32x3_bound_ms(nbytes, flops))
            plan = ops.conv_dw_plan(k, n, h, h, cin, cout, kk, kk, s, "SAME")
            f64 = (f"; from float64 kernel {far[0]:.3e} plain {far[1]:.3e} "
                   f"cuDNN {lib64:.3e}" if far else "")
            log(f"  dw K={k} N={n} {name:13s} x{count} ({h}x{h}, {cin}->"
                f"{cout}, {kk}x{kk} s{s}) err {err:.2e} (cuDNN "
                f"{lib_err:.2e}){f64} kernel "
                f"{t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms library "
                f"{t['library_ms']:.4f} ms bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}; fp32 {t['fp32_bound_ms']:.4f}) tile "
                f"{plan.tile_imgs}x{plan.tile_rows}x{plan.tile_cols} chunk "
                f"{plan.chunk} bn {plan.bn} splits {plan.splits} stages "
                f"{plan.stages} smem {plan.smem_bytes} grid {plan.grid}")
            for key in ("ms", "plain_ms", "library_ms"):
                tot[key] += count * t[key]
            tot["nbytes"] += count * nbytes
            tot["flops"] += count * flops
            if t["ms"] > t["plain_ms"]:
                tot["slower"].append(f"{name} {t['ms']:.4f} against "
                                     f"{t['plain_ms']:.4f}")
            if t["ms"] > t["library_ms"]:
                tot["slower_than_library"].append(name)
            del x, dy, xg, dyg
        bound = rl.tf32x3_bound_ms(tot["nbytes"], tot["flops"])
        log(f"  dw group {group}: kernel {tot['ms']:.4f} ms plain "
            f"{tot['plain_ms']:.4f} ms cuDNN {tot['library_ms']:.4f} ms "
            f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
            f"3xTF32; fp32 {bound['fp32_bound_ms']:.4f}); slower than the "
            f"plain version at {len(tot['slower'])} of {len(convs)} shapes "
            f"{tot['slower']}, than cuDNN at "
            f"{len(tot['slower_than_library'])} {tot['slower_than_library']}")
        rec["groups"][group] = dict(
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            library_ms=tot["library_ms"], **bound,
            slower_than_plain=len(tot["slower"]),
            slower_than_library=len(tot["slower_than_library"]),
            shapes=len(convs))
        if group == "K=4 step":                # the FedGKD cell's step
            rec.update(ms=tot["ms"], plain_ms=tot["plain_ms"],
                       library_ms=tot["library_ms"], **bound)
        torch.cuda.empty_cache()
    return dict(name="grouped_conv_dw", route="cuda",
                source="src/repro_torch/csrc/grouped_conv.cu",
                replaces="none (the reference's weight gradient is outside "
                         "Pallas: src/repro/kernels/grouped_conv/ref.py)",
                **rec)


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

        before = dict(LAUNCHES)
        y = vmap(lambda xi, wi: conv_ops.client_batched_conv(
            xi[None], wi[None], stride=s)[0])(x, w)
        dx, dw = vmap(grad(one, argnums=(0, 1)))(x, w, dy)
        launched = LAUNCHES["grouped_conv_fwd"] - before["grouped_conv_fwd"]
        launched_dw = (LAUNCHES["grouped_conv_dw"]
                       - before["grouped_conv_dw"])
        errs = [compare(f"vmap conv {name}", y,
                        conv_ref.grouped_conv_ref(x, w, s, "SAME")),
                compare(f"vmap(grad) conv dx {name}", dx,
                        conv_ref.grouped_conv_dx(dy, w, s, h, h, "SAME")),
                compare(f"vmap(grad) conv dw {name}", dw,
                        conv_ref.shift_gemm_dw(x, dy, s, kk, kk, "SAME"))]
        if (launched, launched_dw) != (2, 1):
            raise AssertionError(f"B3 under vmap {name}: one K=4 launch a "
                                 f"call expected, got {launched} for 2 and "
                                 f"{launched_dw} weight gradients for 1")
        log(f"  vmap rules: B3 under vmap over K=4 at {name} err y "
            f"{errs[0]:.2e} dx {errs[1]:.2e} dw {errs[2]:.2e}, launches "
            f"{launched} and {launched_dw}")


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
    from repro_torch.launch import roofline as rl

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
        t.update(rl.tf32x3_bound_ms(*rl.flash_cost(b, s, s, hq, hkv, d,
                                                   causal)[:2]))
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


def check_ssd(dev, round_check_len: int) -> dict:
    """B5 against its plain version at the LM path's shapes (a step's batch,
    the evaluation batch, the card-vs-CPU round check's one sequence) and
    at ``SSD_COVERAGE``: y and the final state.  At each shape the gate is
    ``KERNEL_TOL`` of max|plain|; where that fails the plain version runs in
    float64 as well, and the kernel must then be no further from float64
    than the fp32 plain version is.  The record's times are a step's."""
    import torch

    from repro_torch.kernels.ssd_scan import ops, ref
    from repro_torch.launch import roofline as rl

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
        exact = functools.cache(lambda: ref.ssd_chunked(
            *(t.double() for t in args), chunk=q_))
        errs, line = [], ""
        for i, name in enumerate(("y", "state")):
            err, far = nearer_float64(f"ssd_scan_fwd {shape}: {name}", got[i],
                                      want[i], lambda: exact()[i],
                                      always=shape in path[:1])
            errs.append(err)
            if far:
                line += (f"; {name} vs float64: kernel {far[0]:.3e} plain "
                         f"{far[1]:.3e}")
        line = (f"  ssd {shape} err y {errs[0]:.3e} state {errs[1]:.3e} "
                f"(max|plain| {float(want[0].abs().max()):.3e}, "
                f"{float(want[1].abs().max()):.3e})" + line)
        rec["max_abs_err"] = max(rec["max_abs_err"], *errs)
        if shape == path[0]:
            t = dict(ms=time_ms(lambda: ops.ssd_scan_fwd(*args, q_), reps=5,
                                replays=4),
                     plain_ms=time_ms(lambda: ref.ssd_scan_ref(*args, q_),
                                      reps=5, replays=4),
                     library_ms=None)
            t.update(rl.tf32x3_bound_ms(*rl.ssd_cost(*shape)[:2]))
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
    (8184, V) of an evaluation, V = 50,280, at the MoE phase's step
    (``MOE_KD``) and at ``ROW_LSE_COVERAGE``; times the kernel, the plain
    version and ``torch.logsumexp(l / T, -1)`` at the two steps' shapes
    (the LM path's is the kernels line's)."""
    import torch

    from repro_torch.kernels.kd_kl import ops, ref
    from repro_torch.launch import roofline as rl

    gen = torch.Generator(device=dev).manual_seed(6)
    rows = LM_BATCH * (LM_SEQ - 1)
    path = [(rows, LM_VOCAB), (2 * rows, LM_VOCAB), MOE_KD]
    rec = dict(max_abs_err=0.0)
    for t_rows, vocab in path + ROW_LSE_COVERAGE:
        for temp in (1.0, 2.0):
            logits = torch.randn(t_rows, vocab, device=dev, generator=gen) * 3
            want = ref.row_logsumexp_ref(logits, temp)
            err = compare(f"row_logsumexp ({t_rows}, {vocab}) T={temp}",
                          ops.row_lse_fwd(logits, temp), want)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if (t_rows, vocab) not in (path[0], MOE_KD) or temp != 1.0:
                log(f"  row_lse ({t_rows}, {vocab}) T={temp} err {err:.2e}")
                continue

            def library():
                return torch.logsumexp(logits / temp, -1)

            compare("library logsumexp", library(), want)
            t = dict(ms=time_ms(lambda: ops.row_lse_fwd(logits, temp)),
                     plain_ms=time_ms(lambda: ref.row_logsumexp_ref(logits, temp)),
                     library_ms=time_ms(library))
            t["bound_ms"], t["bound_by"] = rl.row_lse_cost(t_rows,
                                                           vocab).bound()
            log(f"  row_lse ({t_rows}, {vocab}) T={temp} err {err:.2e} kernel "
                f"{t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms library "
                f"{t['library_ms']:.4f} ms bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']})")
            if (t_rows, vocab) == path[0]:
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


def device_busy(prof, what: str, wall_ms: float, top: int = 12):
    """The device's busy time in a profiled window of ``wall_ms`` (the union
    of its kernels' and copies' intervals, not the named ranges the
    profiler also draws on the device's timeline), logged with the idle
    share and the device time by kernel name (the ``top`` first, and every
    hand-written kernel of the port); ``None``, logged as not measured,
    where the profiler saw no device activity."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        log(f"profile ({what}): wall {wall_ms:.3f} ms; device busy time not "
            f"measured (the profiler saw no device activity)")
        return None
    busy_us, end, by_name = 0.0, -math.inf, {}
    for lo, hi, name in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + hi - lo, n + 1)
    log(f"profile ({what}): wall {wall_ms:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share "
        f"{1 - busy_us / 1e3 / wall_ms:.4f}, {len(spans)} device ops")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for rank, (name, (t, n)) in enumerate(ranked):
        if rank < top or any(k in name for k in PORT_KERNELS):
            log(f"  {t / 1e3:8.3f} ms {n:5d}x  {name[:90]}")
    return busy_us


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
    busy_us = device_busy(prof, f"{label}, {algo} round 2", wall["ms"])
    if busy_us is None:
        return {}
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


def resnet_task():
    """The ResNet-8 path's task and ``run_federated`` arguments: full
    width; depth cut to 4,500 examples, 1 local epoch, 5 batches per
    client, 3 rounds (the paper: 45,000, 20 epochs, 100 rounds)."""
    from repro_torch.configs.paper import CIFAR10, scaled

    return (scaled(CIFAR10, 0.1, rounds=3, local_epochs=1),
            dict(seed=0, max_batches_per_client=5, width=16))


def resnet_setup():
    """``resnet_task`` with its data."""
    from repro_torch.core import fl_loop

    task, kw = resnet_task()
    return task, fl_loop.make_federated_data(task, alpha=0.5, seed=0), kw


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
    missing = [k for k in ("grouped_conv_fwd", "grouped_conv_dw",
                           "kd_kl_fwd", "kd_kl_bwd") if launches[k] == 0]
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
        missing = [k for k in ("grouped_conv_fwd", "grouped_conv_dw",
                               "kd_kl_fwd", "kd_kl_bwd") if launches[k] == 0]
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


class Killed(Exception):
    """Raised by ``kill_after``'s callback: a run killed mid-way."""


def kill_after(rnd: int):
    """A ``round_callback`` that kills the run after round ``rnd``."""
    def cb(t, *_):
        if t == rnd:
            raise Killed
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
def _on_card_calls(keys: dict, on_call):
    """Inside the block, every call of a wrapper ``getattr(module, name)``
    of ``keys`` whose first argument lies on the card first calls
    ``on_call(name, keys[(module, name)](*args, **kwargs))``; the wrappers
    are put back on exit."""
    originals = {mn: getattr(*mn) for mn in keys}

    def recorder(mn, fn):
        def call(*args, **kwargs):
            if args[0].is_cuda:
                on_call(mn[1], keys[mn](*args, **kwargs))
            return fn(*args, **kwargs)
        return call

    for mn, fn in originals.items():
        setattr(*mn, recorder(mn, fn))
    try:
        yield
    finally:
        for mn, fn in originals.items():
            setattr(*mn, fn)


@contextlib.contextmanager
def record_shapes():
    """Count the calls that the wrappers of B1-B6 get on the card while the
    block runs, by (wrapper name, argument shapes, constants[, B4's
    dtype]): yields the ``collections.Counter``; ``shapes`` gives one
    wrapper's keys.  The wrappers are put back on exit."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_conv import ops as conv_ops
    from repro_torch.kernels.kd_kl import ops as kd_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    keys = {(conv_ops, "grouped_conv_fwd"): lambda x, w, stride, padding: (
                tuple(x.shape), tuple(w.shape), stride, padding),
            (kd_ops, "kd_kl_fwd"): lambda lt, ls, temp: (tuple(lt.shape),
                                                         temp),
            (kd_ops, "kd_kl_bwd"): lambda lt, ls, lse_t, lse_s, g, temp: (
                tuple(lt.shape), temp),
            (kd_ops, "row_lse_fwd"): lambda logits, temp: (
                tuple(logits.shape), temp),
            (fa_ops, "flash_attention_fwd"):
                lambda q, k, v, causal=True, window=None: (
                    tuple(q.shape), tuple(k.shape), bool(causal), window,
                    str(q.dtype)),
            (ssd_ops, "ssd_scan_fwd"):
                lambda x, dt, A, B, C, chunk, init_state=None: (
                    tuple(x.shape), tuple(B.shape), chunk,
                    init_state is not None)}
    seen: collections.Counter = collections.Counter()
    with _on_card_calls(keys, lambda name, key: seen.update([(name,) + key])):
        yield seen


def shapes(seen, name: str) -> set:
    """The keys that ``record_shapes`` counted for the wrapper ``name``."""
    return {key[1:] for key in seen if key[0] == name}


def check_path_shapes(dev, seen: dict, phase: str) -> dict:
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
    err = dict.fromkeys(("grouped_conv_fwd", "kd_kl_fwd", "kd_kl_bwd"), 0.0)
    for xs, ws, stride, padding in sorted(shapes(seen, "grouped_conv_fwd")):
        x = torch.randn(xs, device=dev, generator=gen)
        w = torch.randn(ws, device=dev, generator=gen) / math.sqrt(
            ws[1] * ws[2] * ws[3])
        err["grouped_conv_fwd"] = max(err["grouped_conv_fwd"], compare(
            f"grouped_conv x{xs} w{ws} stride {stride}",
            conv_ops.grouped_conv_fwd(x, w, stride, padding),
            conv_ref.grouped_conv_ref(x, w, stride, padding)))
    kd = shapes(seen, "kd_kl_fwd") | shapes(seen, "kd_kl_bwd")
    for (rows, vocab), temp in sorted(kd):
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
    conv = shapes(seen, "grouped_conv_fwd")
    conv_kn = sorted({xs[:2] for xs, *_ in conv})
    kd_rows = sorted({key[0] for key in kd})
    log(f"{phase} path shapes against their plain versions: B3 at "
        f"{len(conv)} shapes, (K, N) in {conv_kn}; B1/B2 "
        f"at {kd_rows}; max abs err {err}")
    return err


def run_resilience(dev) -> tuple[dict, dict]:
    """``resilience_runs`` with the shapes of B1, B2 and B3 recorded, then
    each kernel checked against its plain version at every one of them
    (``check_path_shapes``).  Returns the launch counts of the card runs
    and each kernel's max abs error."""
    with record_shapes() as seen:
        total = resilience_runs(dev)
    return total, check_path_shapes(dev, seen, "resilience")


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


def run_population(dev, footprint: "dict | None" = None
                   ) -> tuple[dict, dict]:
    """``population_runs`` with the shapes of B1, B2 and B3 recorded, then
    each kernel checked against its plain version at every one of them
    (``check_path_shapes``).  ``footprint``: ``population_footprint``'s
    record, taken now when not given.  Returns the launch counts of the
    card runs and each kernel's max abs error."""
    with record_shapes() as seen:
        total = population_runs(dev, footprint)
    return total, check_path_shapes(dev, seen, "population")


def sampler_ms(n_clients: int) -> float:
    """Milliseconds of one K=``POP_K`` cohort draw over ``n_clients`` in
    shards of ``POP_SYNTH["shard_size"]``, the median of 5 blocks of
    ``POP_SAMPLE_REPS`` draws (the host's clock)."""
    import numpy as np

    from repro_torch.population import HierarchicalSampler, even_shard_sizes

    sampler = HierarchicalSampler(
        even_shard_sizes(n_clients, POP_SYNTH["shard_size"]))
    rng = np.random.default_rng(0)
    sampler.sample(rng, POP_K)
    blocks = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(POP_SAMPLE_REPS):
            sampler.sample(rng, POP_K)
        blocks.append((time.perf_counter() - t0) / POP_SAMPLE_REPS * 1e3)
    return sorted(blocks)[2]


def host_peak_mb() -> tuple[float, str]:
    """This process's peak resident set in MB and where it was read: VmHWM
    (``population.peak_rss_mb``), or ``getrusage``'s ``ru_maxrss`` where
    ``/proc/self/status`` has no VmHWM."""
    import resource

    from repro_torch.population import peak_rss_mb

    mb = peak_rss_mb()
    if math.isfinite(mb):
        return mb, "VmHWM"
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, \
        "ru_maxrss"


def pop_task(n_clients: int):
    """The TOY task over ``n_clients`` with K=``POP_K`` cohorts, batch 16,
    one local epoch, ``POP_ROUNDS`` rounds."""
    from repro_torch.configs.paper import TOY

    return dataclasses.replace(TOY, n_clients=n_clients,
                               participation=POP_K / n_clients,
                               rounds=POP_ROUNDS, local_epochs=1,
                               batch_size=16)


def pop_fedgkd(task):
    from repro_torch.core import algorithms

    return algorithms.make("fedgkd", gamma=task.gamma, buffer_m=task.buffer_m)


def footprint_main() -> int:
    """The child of ``population_footprint`` (``chip_smoke.py
    --population-footprint``): in a process of its own, the 1M-client TOY
    run on the card after a ``POP_CONTROL``-client run of the same task
    (which brings in the CUDA context, the kernels and the vmapped body).
    Prints one JSON line: the peak RSS at its start (Linux carries a
    parent's peak across fork and exec into ``ru_maxrss``), before and
    after the 1M run, the bytes the warm tier holds at its end, its tiers,
    cohorts and seconds per round."""
    import resource

    inherited = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    import torch

    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import fl_loop
    from repro_torch.population import Population

    dev = torch.device("cuda", 0)
    control = pop_task(POP_CONTROL)
    fl_loop.run_federated(control, pop_fedgkd(control), device=dev,
                          population=Population.synthetic(POP_CONTROL,
                                                          **POP_SYNTH),
                          **POP_KW)
    rss0, source = host_peak_mb()
    task = pop_task(POP_CLIENTS)
    pop = Population.synthetic(POP_CLIENTS, **POP_SYNTH)
    hist = fl_loop.run_federated(task, pop_fedgkd(task), population=pop,
                                 device=dev, **POP_KW)
    rss1, _ = host_peak_mb()
    print(json.dumps({
        "rss_inherited_mb": inherited, "rss_before_mb": rss0,
        "rss_after_mb": rss1, "source": source,
        "warm_bytes": sum(c.x.nbytes + c.y.nbytes
                          for c in pop.store.warm.values()),
        "tiers": hist.telemetry["population"],
        "sampled": [[int(c) for c in r.sampled] for r in hist.records],
        "seconds": [r.seconds for r in hist.records]}, default=int))
    return 0


def population_footprint() -> dict:
    """The 1M-client run's host footprint, read in a child process
    (``footprint_main``).  ``main`` runs it before any phase: a child
    starts with its parent's peak RSS, which the later phases' CPU checks
    raise to ~20 GB.  Returns the child's record with its wall seconds."""
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            FOOTPRINT_FLAG], capture_output=True, text=True,
                           timeout=300)
    if child.returncode != 0:
        raise AssertionError(f"population footprint: the child exited "
                             f"{child.returncode}:\n{child.stderr[-4000:]}")
    return dict(json.loads(child.stdout.strip().splitlines()[-1]),
                wall=time.perf_counter() - t0)


def check_footprint(foot: dict, h_card) -> None:
    """Log the child's footprint; its cohorts and tiers must be the card
    run ``h_card``'s."""
    if (foot["sampled"] != [[int(c) for c in r.sampled]
                            for r in h_card.records]
            or foot["tiers"] != h_card.telemetry["population"]):
        raise AssertionError(f"population footprint: the child's run "
                             f"differs from the card run's: {foot}")
    growth = f"{foot['rss_after_mb'] - foot['rss_before_mb']:.1f} MB"
    if foot["rss_before_mb"] <= foot["rss_inherited_mb"]:
        growth += ", not measurable: the peak is the inherited one"
    log(f"population {POP_CLIENTS:,} clients, a child process "
        f"({foot['wall']:.1f} s): peak RSS ({foot['source']}) "
        f"{foot['rss_inherited_mb']:.1f} MB at its start, "
        f"{foot['rss_before_mb']:.1f} MB after a {POP_CONTROL:,}-client "
        f"run, {foot['rss_after_mb']:.1f} MB after the {POP_CLIENTS:,}-"
        f"client run (growth {growth}); the warm tier holds "
        f"{foot['tiers']['warm_resident']} clients, {foot['warm_bytes']:,} "
        f"bytes; seconds per round {foot['seconds']}")


def population_runs(dev, footprint: "dict | None" = None) -> dict:
    """The population tier (``run_federated(population=)``), every card run
    with the launch counts set to 0 just before and read just after:

      1. a million registered clients (``Population.synthetic``, the
         reference bench's setting): the sampler's K=64 draw at 1M within
         ``POP_SAMPLE_RATIO`` of its time at 10k; FedGKD on the TOY task's
         MLP through the vmap executor (B1/B2 under vmap) for 3 rounds of
         K=64: cohorts and tier counters equal to a CPU run's of the same
         population, ``peak_warm`` within the warm cap, cold loads at most
         the cohorts and the probe client, round 1 against the CPU's; its
         seconds per round, its host footprint in a child process
         (``footprint``, or ``population_footprint`` now), a profiled
         round;
      2. ResNet-8 at full width (``resnet_setup``) written to disk shards of
         ``POP_DISK_SHARD`` clients and trained with FedGKD from
         ``DiskShardSource`` with a warm cap of ``POP_DISK_WARM``: with a
         one-shard sampler equal to the ``data=`` run (the same cohorts,
         params within ``POP_EQ_TOL``), with the 4-shard sampler evicting
         from the warm tier and releasing every pin; a profiled round;
      3. FedDyn (the sequential route, B3 at K=1) with a state warm cap of
         ``POP_STATE_WARM`` for 3 rounds: equal to the ``data=`` run within
         ``POP_EQ_TOL``, its dual states spilled to disk and reloaded;
      4. the resilience phase's async run (``async_executor``) with
         ``population=``: the ``data=`` run's buffers; killed after
         aggregation 3 and resumed, bitwise equal to the uninterrupted run
         with no pin left.

    Returns the launch counts summed over the card runs."""
    import tempfile

    from repro_torch.core import algorithms, fl_loop
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.population import (DiskShardSource, HierarchicalSampler,
                                        Population, write_population_shards)

    t_phase = time.perf_counter()
    total = dict.fromkeys(LAUNCHES, 0)
    kd = ["kd_kl_fwd", "kd_kl_bwd"]
    path_kernels = kd + ["grouped_conv_fwd"]

    def drive(label, task, algo, kernels, **run_kw):
        reset_launches()
        t0 = time.perf_counter()
        hist = fl_loop.run_federated(task, algo, device=dev, **run_kw)
        launches = dict(LAUNCHES)
        log(f"population {label}: {time.perf_counter() - t0:.2f} s, "
            f"launches { {k: n for k, n in launches.items() if n} }, tiers "
            f"{hist.telemetry.get('population')}")
        for r in hist.records:
            log(f"  round {r.round}: {r.seconds:.3f} s test_acc "
                f"{r.test_acc:.4f} local_loss {r.mean_local_loss:.4f} "
                f"sampled {list(r.sampled)[:8]}"
                f"{' ...' if len(r.sampled) > 8 else ''}")
        losses = [v for r in hist.records
                  for v in (r.test_loss, r.mean_local_loss)]
        if not (all(map(math.isfinite, losses))
                and all_finite(hist.final_params)):
            raise AssertionError(f"population {label}: non-finite loss or "
                                 f"params {losses}")
        missing = [k for k in kernels if launches[k] == 0]
        if missing:
            raise AssertionError(f"population {label}: not launched "
                                 f"{missing}")
        for k, n in launches.items():
            total[k] += n
        return hist

    def same_cohorts(label, a, b) -> None:
        if [r.sampled for r in a.records] != [r.sampled for r in b.records]:
            raise AssertionError(f"population {label}: the cohorts differ")

    def within(label, a, b, tol) -> None:
        diff = params_diff(a.final_params, b.final_params)
        log(f"population {label}: max abs param diff {diff:.3e} (limit "
            f"{tol})")
        if not diff <= tol:
            raise AssertionError(f"population {label}: {diff} > {tol}")

    # 1. a million registered clients
    big, small = sampler_ms(POP_CLIENTS), sampler_ms(POP_CONTROL)
    log(f"population sampler, K={POP_K}: {POP_CLIENTS:,} clients {big:.4f} "
        f"ms, {POP_CONTROL:,} clients {small:.4f} ms, ratio "
        f"{big / small:.3f} (limit {POP_SAMPLE_RATIO})")
    if big > POP_SAMPLE_RATIO * small:
        raise AssertionError(f"population: the draw at {POP_CLIENTS:,} "
                             f"clients is {big / small:.3f}x the draw at "
                             f"{POP_CONTROL:,}")
    task, kw, fedgkd = pop_task(POP_CLIENTS), POP_KW, pop_fedgkd

    def synthetic():
        return Population.synthetic(POP_CLIENTS, **POP_SYNTH)

    card, cpu = {}, {}
    h_card = drive(f"{POP_CLIENTS:,} clients, TOY FedGKD K={POP_K}", task,
                   fedgkd(task), kd, population=synthetic(),
                   round_callback=capture_round(1, card), **kw)
    stats = h_card.telemetry["population"]
    log(f"population {POP_CLIENTS:,} clients: seconds per round "
        f"{[r.seconds for r in h_card.records]}")
    if not (stats["peak_warm"] <= POP_SYNTH["warm_cap"]
            and stats["cold_loads"] <= POP_ROUNDS * POP_K + 1
            and stats["pinned"] == 0 and stats["n_shards"] == 245):
        raise AssertionError(f"population {POP_CLIENTS:,} clients: tiers "
                             f"{stats}")
    h_cpu = fl_loop.run_federated(task, fedgkd(task), population=synthetic(),
                                  device="cpu",
                                  round_callback=capture_round(1, cpu), **kw)
    same_cohorts("1M clients, card against CPU", h_card, h_cpu)
    if stats != h_cpu.telemetry["population"]:
        raise AssertionError(f"population: the card's tiers {stats}, the "
                             f"CPU's {h_cpu.telemetry['population']}")
    check_footprint(footprint or population_footprint(), h_card)
    init = fl_loop.run_federated(task, fedgkd(task), population=synthetic(),
                                 device="cpu", rounds=0, **kw)
    leaves = {("cpu", 0): tree_leaves_np(init.final_params),
              (str(dev), 1): card["params"], ("cpu", 1): cpu["params"]}
    first_round_check(dev, f"TOY FedGKD over {POP_CLIENTS:,} clients",
                      task.lr,
                      lambda device, rounds: leaves[(str(device), rounds)])
    profile_round(dev, f"TOY population of {POP_CLIENTS:,}",
                  lambda cb: fl_loop.run_federated(
                      task, fedgkd(task), population=synthetic(), device=dev,
                      rounds=2, round_callback=cb, **kw))

    # 2. ResNet-8 at full width from disk shards
    rtask, rdata, rkw = resnet_setup()
    eager = drive("ResNet-8 FedGKD, data=", rtask, fedgkd(rtask),
                  path_kernels, data=rdata, **rkw)
    with tempfile.TemporaryDirectory() as root:
        meta = write_population_shards(root, iter(rdata.clients),
                                       shard_size=POP_DISK_SHARD)

        def disk(one_shard: bool):
            pop = Population(DiskShardSource(root), rdata.test_x,
                             rdata.test_y, warm_cap=POP_DISK_WARM)
            if one_shard:
                # the sampler's geometry of the eager run: its cohorts
                pop.sampler = HierarchicalSampler([pop.n_clients])
            return pop

        log(f"population disk shards: {meta['shard_sizes']}")
        one = drive("ResNet-8 FedGKD from disk shards, one-shard sampler",
                    rtask, fedgkd(rtask), path_kernels,
                    population=disk(True), **rkw)
        same_cohorts("disk shards against data=", one, eager)
        within("disk shards (one-shard sampler) against data=", one, eager,
               POP_EQ_TOL)
        four = drive(f"ResNet-8 FedGKD from disk shards, "
                     f"{len(meta['shard_sizes'])}-shard sampler",
                     rtask, fedgkd(rtask), path_kernels,
                     population=disk(False), **rkw)
        tiers = four.telemetry["population"]
        if not (tiers["warm_evictions"] > 0 and tiers["pinned"] == 0):
            raise AssertionError(f"population disk shards: tiers {tiers}")
        profile_round(dev, "ResNet-8 from disk shards", lambda cb:
                      fl_loop.run_federated(
                          rtask, fedgkd(rtask), population=disk(False),
                          device=dev, rounds=2, round_callback=cb, **rkw))

    # 3. FedDyn's dual states through the state tier's spills
    dyn_eager = drive("ResNet-8 FedDyn, data=", rtask,
                      algorithms.make("feddyn"), ["grouped_conv_fwd"],
                      data=rdata, **rkw)
    with tempfile.TemporaryDirectory() as state_dir:
        dyn = drive(f"ResNet-8 FedDyn, state warm cap {POP_STATE_WARM}",
                    rtask, algorithms.make("feddyn"), ["grouped_conv_fwd"],
                    population=Population.from_federated(
                        rdata, state_warm_cap=POP_STATE_WARM,
                        state_dir=state_dir), **rkw)
    same_cohorts("FedDyn against data=", dyn, dyn_eager)
    within("FedDyn, spilled states, against data=", dyn, dyn_eager,
           POP_EQ_TOL)
    tiers = dyn.telemetry["population"]
    if not (dyn.telemetry["route"] == "sequential"
            and tiers["state_spills"] > 0 and tiers["state_loads"] > 0):
        raise AssertionError(f"population FedDyn: route "
                             f"{dyn.telemetry['route']}, tiers {tiers}")

    # 4. async, killed and resumed, with population=
    akw = dict(rkw, rounds=RES_AGGS)
    a_eager = drive("async, data=", rtask, fedgkd(rtask), path_kernels,
                    data=rdata, executor=async_executor(), **akw)
    full = drive("async, population=", rtask, fedgkd(rtask), path_kernels,
                 population=Population.from_federated(rdata),
                 executor=async_executor(), **akw)
    same_cohorts("async against data=", full, a_eager)
    with tempfile.TemporaryDirectory() as ck:
        try:
            drive("async, population=, killed after 3", rtask, fedgkd(rtask),
                  path_kernels, population=Population.from_federated(rdata),
                  executor=async_executor(), checkpoint_dir=ck,
                  round_callback=kill_after(3), **akw)
        except Killed:
            pass
        else:
            raise AssertionError("population async: the run was not killed")
        resumed = drive("async, population=, resumed", rtask, fedgkd(rtask),
                        path_kernels,
                        population=Population.from_federated(rdata),
                        executor=async_executor(), checkpoint_dir=ck,
                        resume=True, **akw)
    diff = assert_same_history("population async, resumed", full, resumed)
    log(f"population async: resumed against uninterrupted, records equal, "
        f"max abs param diff {diff!r}")
    if diff != 0.0 or resumed.telemetry["population"]["pinned"] != 0:
        raise AssertionError(f"population async resume: diff {diff}, tiers "
                             f"{resumed.telemetry['population']}")
    log(f"population phase: {time.perf_counter() - t_phase:.1f} s")
    return total


def keep_rounds(into: dict):
    """A ``round_callback`` that keeps the global after every round as
    numpy leaves in ``into[round]``."""
    def cb(t, server, model):
        into[t] = tree_leaves_np(server["global"])
    return cb


def run_multihost(dev) -> tuple[dict, dict]:
    """``multihost_runs`` with the shapes of B1, B2 and B3 recorded in this
    process and reported by the children, then each kernel checked against
    its plain version at every one of them (``check_path_shapes``).
    Returns the launch counts of the card runs (the children's included)
    and each kernel's max abs error."""
    with record_shapes() as seen:
        total, child_seen = multihost_runs(dev)
    seen.update(child_seen)
    return total, check_path_shapes(dev, seen, "multihost")


def _tuples(obj):
    """JSON's lists back to the tuples ``record_shapes`` keys by."""
    return tuple(_tuples(v) for v in obj) if isinstance(obj, list) else obj


def mh_population(root: Path, host=None, exchange=None,
                  timeout_s: float = MH_TIMEOUT_S):
    """The disk-shard population of the multi-host phase (``root/shards``,
    the test split in ``root/test.npz``, warm cap ``POP_DISK_WARM``),
    placed on ``host`` of ``MH_HOSTS`` over ``root/exchange/<exchange>``
    when ``host`` is given."""
    import numpy as np

    from repro_torch.population import (DiskShardSource, HostPlacement,
                                        Population)

    placement = None
    if host is not None:
        placement = HostPlacement(
            host, MH_HOSTS, exchange_dir=str(root / "exchange" / exchange),
            timeout_s=timeout_s)
    with np.load(root / "test.npz") as z:
        test_x, test_y = z["x"], z["y"]
    return Population(DiskShardSource(str(root / "shards")), test_x, test_y,
                      warm_cap=POP_DISK_WARM, placement=placement)


def mh_faults():
    from repro_torch.core import systemsim

    return systemsim.FaultProfile(host_crash_prob=MH_HOST_CRASH, **RES_CHAOS)


def multihost_child(argv: list[str]) -> int:
    """One host process of the multi-host phase (``chip_smoke.py
    --multihost-child HOST ROOT STAGE DEVICE``), on the parent's device
    beside its peer (``cuda:0``).
    Stage ``main`` runs, each over its own exchange directory: FedGKD for
    ``MH_ROUNDS`` rounds (timed), a profiled round 2, FedGKD under
    ``mh_faults`` for ``MH_KILL_ROUNDS`` rounds, the async run for
    ``MH_AGGS`` aggregations, the fault run again on the CPU (cut to
    ``MH_CPU_BATCHES`` batch a client and one evaluation: the counters
    depend only on the fault draws and the validation gate, which passes
    every clean upload and rejects every corrupt one), and last the fault
    run with
    checkpoints, in which host 1 exits (code 17) right after round 2.
    Stage ``resume`` restarts that run with ``resume=True``.  Every card
    run's B1-B3 launches must be non-zero.  Each run's report (records,
    telemetry, launches, the placement's exchange counters) goes to
    ``ROOT/out/<run>_host<HOST>.json`` and its params to ``.npz`` beside
    it; the shapes B1-B3 were called with to ``shapes_host<HOST>.json``."""
    host, root, stage, device = int(argv[0]), Path(argv[1]), argv[2], argv[3]
    import numpy as np
    import torch

    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    from repro_torch.core import fl_loop
    from repro_torch.kernels import LAUNCHES, build, reset_launches

    dev = torch.device(device)
    if dev.type == "cuda":
        build.library()                 # built by the parent: a load
    task, kw = resnet_task()
    path_kernels = ("kd_kl_fwd", "kd_kl_bwd", "grouped_conv_fwd")

    def run(name, device=dev, timeout_s=MH_TIMEOUT_S, exchange=None,
            keep=False, **run_kw):
        pop = mh_population(root, host, exchange or name, timeout_s)
        kept: dict = {}
        if keep:
            run_kw["round_callback"] = keep_rounds(kept)
        reset_launches()
        hist = fl_loop.run_federated(task, pop_fedgkd(task), population=pop,
                                     device=device, **{**kw, **run_kw})
        if keep:
            np.savez(root / "out" / f"{name}_rounds_host{host}.npz",
                     **{f"r{t}_{i}": leaf for t, leaves in kept.items()
                        for i, leaf in enumerate(leaves)})
        launches = dict(LAUNCHES)
        if (device == dev and dev.type == "cuda"
                and not all(launches[k] for k in path_kernels)):
            raise AssertionError(f"multihost host {host} {name}: B1-B3 "
                                 f"not launched: {launches}")
        np.savez(root / "out" / f"{name}_host{host}.npz",
                 *tree_leaves_np(hist.final_params))
        pl = pop.placement.stats
        report = {
            "records": [dataclasses.asdict(r) for r in hist.records],
            "hosts": json.dumps(hist.telemetry["population"]["hosts"],
                                sort_keys=True),
            "faults": hist.telemetry.get("faults"), "launches": launches,
            "publish_ms": pl.get("publish_ms", 0.0) / pl["exchanges"],
            "gather_ms": pl.get("gather_ms", 0.0) / pl["exchanges"],
            "exchanges": pl["exchanges"], "timeouts": pl.get("timeouts", 0)}
        (root / "out" / f"{name}_host{host}.json").write_text(
            json.dumps(report))
        log(f"host {host} {name}: {dict(report, hosts='...')}")
        return hist

    with record_shapes() as seen:
        if stage == "resume":
            run("resumed", exchange="killed", rounds=MH_KILL_ROUNDS,
                faults=mh_faults(), checkpoint_dir=str(root / "ck"),
                resume=True)
        else:
            run("main", rounds=MH_ROUNDS, keep=True)
            prof = profile_round(dev, f"multihost host {host}", lambda cb: (
                fl_loop.run_federated(task, pop_fedgkd(task), device=dev,
                                      population=mh_population(
                                          root, host, "profile"),
                                      rounds=2, round_callback=cb, **kw)))
            (root / "out" / f"profile_host{host}.json").write_text(
                json.dumps(prof))
            run("faults", rounds=MH_KILL_ROUNDS, faults=mh_faults())
            run("async", rounds=MH_AGGS, executor=async_executor(),
                keep=True)
            run("faults_cpu", device="cpu", rounds=MH_KILL_ROUNDS,
                faults=mh_faults(), max_batches_per_client=MH_CPU_BATCHES,
                eval_every=MH_KILL_ROUNDS)
    (root / "out" / f"shapes_{stage}_host{host}.json").write_text(json.dumps(
        list(seen.items())))
    if stage == "main":
        # the kill: host 1 exits right after round 2's checkpoint; host 0
        # misses its deadline once and runs on alone
        def die(t, *_):
            if host == 1 and t == 2:
                os._exit(17)

        run("killed", rounds=MH_KILL_ROUNDS, faults=mh_faults(),
            checkpoint_dir=str(root / "ck"), round_callback=die,
            timeout_s=MH_KILL_TIMEOUT_S)
    return 0


def spawn_hosts(root: Path, stage: str, dev) -> list:
    """The ``MH_HOSTS`` host processes of ``stage`` on ``dev``, fresh
    interpreters (nothing forks this process's CUDA context)."""
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), MULTIHOST_FLAG,
         str(h), str(root), stage, str(dev)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for h in range(MH_HOSTS)]


def wait_hosts(procs: list, label: str, expect_rc=None) -> None:
    """Wait for the processes, relay their output, check their exit codes
    (``expect_rc``: index -> code, default 0); a time-out kills them."""
    try:
        outs = [p.communicate(timeout=MH_WAIT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for h, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            log(f"  [{label} {h}] {line}")
        want = (expect_rc or {}).get(h, 0)
        if p.returncode != want:
            raise AssertionError(f"multihost {label} {h} exited "
                                 f"{p.returncode}, wanted {want}")


def multihost_runs(dev) -> tuple[dict, dict]:
    """Multi-host placement on the card: the population phase's ResNet-8
    disk shards (4 shards of 5 clients, warm cap 4) placed over two host
    processes on ``cuda:0``, each owning 2 shards, FedGKD with K=4 and
    batch 64 (``resnet_task``):

      1. one host in this process, the yardsticks: FedGKD for
         ``MH_ROUNDS`` rounds and the async run (``async_executor``) for
         ``MH_AGGS`` aggregations over the same population; then
         ``ShardMapExecutor(strict=True)`` with the device list
         ``["cuda:0", "cuda:0"]`` (two slices) at K=4 and at K=3 (one
         phantom client), one round each against the vmap executor's,
         within ``MH_TOL`` of its max |param|;
      2. the two host processes (``multihost_child``, stage ``main``): the
         hosts agree bitwise (params, accuracies, the gathered telemetry);
         their global after round 1 equals the one-host run's within
         ``MH_TOL`` of its max |param|, and every round's difference is
         printed (a host trains K = 1-3 clients where one host trains
         K=4, so cuBLAS may pick other weight-gradient algorithms: bitwise
         is not assumed, and training amplifies the fp32 reorderings by
         round 3 past ``MH_TOL``: 3.9e-5 in PR 20's first card run);
         under host crashes and the CHAOS client faults the hosts agree
         bitwise and their fault counters equal their CPU run's; the
         async run's hosts agree bitwise, its clock and buffers equal the
         one-host async run's exactly and its aggregation 1 within
         ``MH_TOL``; the round walls (rounds 2-3) of 2 hosts and of 1,
         each host's publish and gather ms an exchange, a host's round-2
         idle share;
      3. host 1 killed after round 2 of ``MH_KILL_ROUNDS``, then both
         restarted with ``resume=True`` (stage ``resume``): equal to the
         uninterrupted fault run bit for bit; beside it, two ranks of
         ``python -m repro_torch.launch.distributed`` on gloo: the
         stitched array's sum and one placed FedAvg round.

    Returns the launch counts of every card run, the children's included,
    and the shapes the children saw B1-B3 at."""
    import tempfile

    import numpy as np

    from repro_torch.core import executor, fl_loop
    from repro_torch.kernels import LAUNCHES, build, reset_launches
    from repro_torch.launch.distributed import find_free_port
    from repro_torch.population import write_population_shards

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        build.library()         # the children load it, they do not build
    task, data, kw = resnet_setup()
    total = dict.fromkeys(LAUNCHES, 0)
    path_kernels = ("kd_kl_fwd", "kd_kl_bwd", "grouped_conv_fwd")

    def drive(label, run_task=task, **run_kw):
        reset_launches()
        hist = fl_loop.run_federated(run_task, pop_fedgkd(run_task),
                                     device=dev, **{**kw, **run_kw})
        launches = dict(LAUNCHES)
        if not all(launches[k] for k in path_kernels):
            raise AssertionError(f"multihost {label}: B1-B3 not launched: "
                                 f"{launches}")
        for k, n in launches.items():
            total[k] += n
        return hist

    def scaled_diff(label, got: list, want: list) -> float:
        diff = max(float(abs(a - b).max()) for a, b in zip(got, want,
                                                           strict=True))
        scale = max(float(abs(b).max()) for b in want)
        log(f"multihost {label}: max abs param diff {diff!r} (limit "
            f"{MH_TOL} x {scale:.4f}; bitwise: {diff == 0.0})")
        if not diff <= MH_TOL * scale:
            raise AssertionError(f"multihost {label}: {diff}")
        return diff


    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "out").mkdir()
        meta = write_population_shards(str(root / "shards"),
                                       iter(data.clients),
                                       shard_size=POP_DISK_SHARD)
        np.savez(root / "test.npz", x=data.test_x, y=data.test_y)
        log(f"multihost: shards {meta['shard_sizes']}, {MH_HOSTS} hosts on "
            f"one card, host h owns the shards s with s % {MH_HOSTS} == h")

        # 1. one host, and the shard_map executor in this process
        one_rounds, one_async_rounds = {}, {}
        one = drive("one host", population=mh_population(root),
                    rounds=MH_ROUNDS,
                    round_callback=keep_rounds(one_rounds))
        one_async = drive("one host, async", population=mh_population(root),
                          rounds=MH_AGGS, executor=async_executor(),
                          round_callback=keep_rounds(one_async_rounds))
        for part in (0.2, 0.15):
            cut = dataclasses.replace(task, participation=part, rounds=1)
            vm = drive(f"vmap, C={part}", run_task=cut, data=data,
                       executor="vmap")
            sm = drive(f"shard_map, C={part}", run_task=cut, data=data,
                       executor=executor.ShardMapExecutor(
                           strict=True, devices=[dev] * 2))
            tele = sm.telemetry
            log(f"multihost shard_map: K={tele['cohort']} padded to "
                f"{tele['padded_to']} on {tele['n_devices']} slices, body "
                f"{tele['round_body']}, slabs {tele['placement']}")
            if tele["route"] != "shard_map":
                raise AssertionError(f"multihost shard_map: route {tele}")
            scaled_diff(f"shard_map K={tele['cohort']} against vmap",
                        tree_leaves_np(sm.final_params),
                        tree_leaves_np(vm.final_params))

        # 2. two hosts
        t0 = time.perf_counter()
        wait_hosts(spawn_hosts(root, "main", dev), "host", expect_rc={1: 17})
        log(f"multihost: the two host processes {time.perf_counter() - t0:.1f}"
            f" s")

        def report(name, host):
            return json.loads((root / "out" /
                               f"{name}_host{host}.json").read_text())

        def params(name, host):
            with np.load(root / "out" / f"{name}_host{host}.npz") as z:
                return [z[f"arr_{i}"] for i in range(len(z.files))]

        def against_one_host(label, name, want: dict) -> None:
            """Host 0's global after every round against the one-host
            run's: round 1 within ``MH_TOL`` of its max |param| (the
            exchange and the aggregation in full), the later rounds
            printed, fp32 reorderings amplified by training."""
            with np.load(root / "out" / f"{name}_rounds_host0.npz") as z:
                got = {t: [z[f"r{t}_{i}"] for i in range(len(leaves))]
                       for t, leaves in want.items()}
            diffs = {t: max(float(abs(a - b).max()) for a, b in zip(
                got[t], want[t], strict=True)) for t in sorted(want)}
            scale = max(float(abs(b).max()) for b in want[1])
            log(f"multihost {label}: max abs param diff by round {diffs} "
                f"(round 1's limit {MH_TOL} x {scale:.4f}); bitwise at the "
                f"end: {diffs[max(diffs)] == 0.0}")
            if not diffs[1] <= MH_TOL * scale or not all(
                    map(math.isfinite, diffs.values())):
                raise AssertionError(f"multihost {label}: {diffs}")

        def hosts_agree(name):
            r0, r1 = report(name, 0), report(name, 1)
            # a record's seconds are its host's own
            r0["walls"] = [[rec.pop("seconds") for rec in r["records"]]
                           for r in (r0, r1)]
            for field in ("records", "hosts", "faults"):
                if r0[field] != r1[field]:
                    raise AssertionError(f"multihost {name}: the hosts' "
                                         f"{field} differ")
            if not all(np.array_equal(a, b) for a, b in zip(
                    params(name, 0), params(name, 1), strict=True)):
                raise AssertionError(f"multihost {name}: the hosts' params "
                                     f"differ")
            for h in range(MH_HOSTS):
                launches = report(name, h)["launches"]
                for k, n in launches.items():
                    total[k] += n
            return r0

        main = hosts_agree("main")
        against_one_host("2 hosts against 1", "main", one_rounds)
        log(f"multihost round walls, rounds 2-{MH_ROUNDS} (s): 2 hosts "
            f"{[w[1:] for w in main['walls']]} (host 0, host 1), 1 host "
            f"{[r.seconds for r in one.records[1:]]}")
        for h in range(MH_HOSTS):
            r = report("main", h)
            log(f"multihost host {h}: publish {r['publish_ms']:.3f} ms, "
                f"gather {r['gather_ms']:.3f} ms an exchange "
                f"({r['exchanges']} exchanges, {r['timeouts']} time-outs)")
            prof = json.loads((root / "out" /
                               f"profile_host{h}.json").read_text())
            if prof:
                log(f"multihost host {h}, round 2: wall "
                    f"{prof['wall_ms']:.3f} ms, busy {prof['busy_ms']:.3f} "
                    f"ms, idle share "
                    f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f}")
        faults, cpu = hosts_agree("faults"), hosts_agree("faults_cpu")
        log(f"multihost faults: card {faults['faults']}; CPU "
            f"{cpu['faults']}")
        if faults["faults"] != cpu["faults"]:
            raise AssertionError("multihost faults: the card's counters "
                                 "differ from the CPU's")
        if not faults["faults"]["host_crashes"] > 0:
            raise AssertionError("multihost faults: no host crashed")
        asy = hosts_agree("async")
        for ra, rb in zip(asy["records"], one_async.records, strict=True):
            for f in ("round", "sim_time", "version", "mean_staleness"):
                if ra[f] != getattr(rb, f):
                    raise AssertionError(f"multihost async: aggregation "
                                         f"{ra['round']}'s {f}")
            if tuple(ra["sampled"]) != rb.sampled:
                raise AssertionError(f"multihost async: aggregation "
                                     f"{ra['round']}'s buffer")
        against_one_host("async, 2 hosts against 1", "async",
                         one_async_rounds)

        # 3. the resume, and launch.distributed beside it
        killed = report("killed", 0)
        if killed["faults"]["host_timeouts"] != 1:
            raise AssertionError(f"multihost kill: host 0 {killed}")
        kept = sorted(p.name for p in (root / "ck").glob("*.npz"))
        log(f"multihost kill: host 0 ran on alone after one time-out; "
            f"checkpoints {kept}")
        coord = f"127.0.0.1:{find_free_port()}"
        env = dict(os.environ, PYTHONPATH=str(SRC))
        ranks = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.distributed",
             "--coordinator", coord, "--num-processes", "2", "--process-id",
             str(r), "--exchange-dir", str(root / "exchange" / "distributed"),
             "--device", str(dev)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        resumed = spawn_hosts(root, "resume", dev)
        wait_hosts(ranks, "rank")
        wait_hosts(resumed, "resumed host")
        res = hosts_agree("resumed")
        if res["records"] != faults["records"]:
            raise AssertionError("multihost resume: the records differ from "
                                 "the uninterrupted run's")
        diff = max(float(abs(a - b).max()) for a, b in zip(
            params("resumed", 0), params("faults", 0), strict=True))
        log(f"multihost resume: records equal, max abs param diff against "
            f"the uninterrupted run {diff!r}; counters {res['faults']}")
        if diff != 0.0 or res["faults"] != faults["faults"]:
            raise AssertionError(f"multihost resume: {diff}")
        child_seen = collections.Counter()
        for stage in ("main", "resume"):
            for h in range(MH_HOSTS):
                got = json.loads((root / "out" /
                                  f"shapes_{stage}_host{h}.json").read_text())
                for key, n in got:
                    child_seen[_tuples(key)] += n
    log(f"multihost phase: {time.perf_counter() - t_phase:.1f} s")
    return total, child_seen


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
    fp32: the LM path's phase keeps its fp32 gates (the published bf16 runs
    in ``run_bf16``)."""
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


# ---------------------------------------------------------------------------
# the serve phase: the LM serve path on the dense, SSM and hybrid families
# ---------------------------------------------------------------------------

def serve_config(arch: str, n_layers: int, **kw):
    """``arch`` at its published width, depth cut to ``n_layers``, in fp32:
    the serve phase keeps its fp32 gates (the published bf16 runs in
    ``run_bf16``)."""
    from repro_torch.configs import get_config

    return get_config(arch).replace(n_layers=n_layers, param_dtype="float32",
                                    activation_dtype="float32", **kw)


def serve_cuts(cfg) -> str:
    """The cuts of a config against the published one."""
    from repro_torch.configs import get_config

    full = get_config(cfg.name)
    cuts = [f"depth {full.n_layers} -> {cfg.n_layers}"]
    if cfg.param_dtype != full.param_dtype:
        cuts.append(f"{full.param_dtype} -> {cfg.param_dtype}")
    return ", ".join(cuts)


def card_init(cfg, dev, seed: int = 0, init=None):
    """The port's initialiser (``init``, by default ``transformer.init``)
    with its weights drawn on the card from a CUDA generator (a CPU draw of
    phi4-mini's 0.8B weights takes minutes); the norms, made on the CPU,
    are moved over."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    gen = torch.Generator(device=dev).manual_seed(seed)
    return tree_map(lambda t: t.to(dev), (init or transformer.init)(gen, cfg))


@contextlib.contextmanager
def card_weights(dev):
    """``transformer.init`` draws on the card (``card_init``) inside the
    block, for the trainers, which call it with a CPU generator."""
    from repro_torch.models import transformer

    real_init = transformer.init
    transformer.init = lambda gen, c: card_init(c, dev, init=real_init)
    try:
        yield
    finally:
        transformer.init = real_init


def greedy_decode(cfg, params, prompt, steps: int, dev, enc_out=None):
    """Decode ``prompt`` (B, S) one position at a time through caches in
    the activations' dtype (fp32 for the fp32 phases, the reference's bf16
    default for bf16 models), then ``steps`` greedy tokens: (each fed
    position's logits (B, S + steps, V), the tokens fed (B, S + steps)).
    An encoder-decoder's steps attend to ``enc_out``."""
    import torch

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer

    step = make_serve_step(cfg)
    b, s = prompt.shape
    cache = transformer.init_cache(cfg, b, s + steps, cfg.adtype, device=dev)
    fed, outs, tok = [], [], None
    for i in range(s + steps):
        tok = prompt[:, i:i + 1] if i < s else tok
        fed.append(tok)
        logits, cache = step(params, cache, tok, enc_out)
        outs.append(logits[:, 0])
        tok = torch.argmax(logits[:, -1:], dim=-1)
    return torch.stack(outs, dim=1), torch.cat(fed, dim=1)


def decode_vs_forward(label, cfg, params, dev, prompt_len: int,
                      steps: int, enc_out=None) -> float:
    """Greedy decode logits against the teacher-forced forward over the
    same tokens on the card (an encoder-decoder's both with ``enc_out``);
    gates at the reference's bar (``DECODE_TOL`` absolute and relative,
    tests/test_arch_smoke.py:79)."""
    import torch

    from repro_torch.models import transformer

    gen = torch.Generator(device=dev).manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_CHECK_BATCH, prompt_len),
                           device=dev, generator=gen)
    dec, toks = greedy_decode(cfg, params, prompt, steps, dev, enc_out)
    with torch.no_grad():
        full, _ = transformer.forward(params, cfg, toks, enc_out=enc_out)
    return against_forward(f"{label}: greedy decode over {toks.shape[1]} "
                           f"positions", dec, full)


def against_forward(what: str, dec, full) -> float:
    """Decode logits against the forward's at the reference's bar, |dec -
    full| <= DECODE_TOL (1 + |full|); logs and returns the max abs diff."""
    err = float((dec - full).abs().max())
    ratio = float(((dec - full).abs() / (DECODE_TOL * (1 + full.abs())))
                  .max())
    log(f"  {what} against the teacher-forced forward: max abs {err:.3e} "
        f"(max |logit| {float(full.abs().max()):.3e}), {ratio:.3e} of the "
        f"bar {DECODE_TOL} + {DECODE_TOL} |forward|")
    if not ratio <= 1.0:
        raise AssertionError(f"{what}: {err:.3e} from the forward, "
                             f"{ratio:.3e} of the reference's bar")
    return err


def serve_on(cfg, params, prompts, dev) -> dict:
    from repro_torch.launch.serve import ServeLoop

    loop = ServeLoop(cfg, params, SERVE_REQ["batch"],
                     SERVE_REQ["prompt_len"] + SERVE_REQ["gen"] + 1)
    return loop.run(prompts, SERVE_REQ["gen"])


def serve_tokens_vs_cpu(label, cfg, params, prompts, card_out, dev) -> None:
    """``ServeLoop`` on the CPU from the card's params: its tokens must equal
    the card's.  Where they differ, the first differing (request, step) of
    the wave is replayed on both devices with the CPU's tokens fed, and the
    divergence passes only if the CPU's top-2 logit gap there is below the
    card-vs-CPU logit difference (a near-tie that fp32 rounding may flip)."""
    import torch

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu = serve_on(cfg, cpu_params, prompts, torch.device("cpu"))
    if cpu["decode_steps"] != card_out["decode_steps"]:
        raise AssertionError(f"{label}: decode steps card "
                             f"{card_out['decode_steps']} CPU "
                             f"{cpu['decode_steps']}")
    diff = [(rid, next(i for i, (a, b) in enumerate(zip(
        card_out["outputs"][rid], cpu["outputs"][rid])) if a != b))
        for rid in sorted(cpu["outputs"])
        if cpu["outputs"][rid] != card_out["outputs"][rid]]
    if not diff:
        log(f"  {label}: ServeLoop tokens on the card equal the CPU's "
            f"({len(prompts)} requests x {SERVE_REQ['gen']} tokens; CPU "
            f"{cpu['seconds']:.2f} s)")
        return
    rid, step = diff[0]
    wave = rid // SERVE_REQ["batch"]
    reqs = list(range(wave * SERVE_REQ["batch"],
                      min(len(prompts), (wave + 1) * SERVE_REQ["batch"])))
    plen = max(len(prompts[r]) for r in reqs)
    toks = torch.zeros((SERVE_REQ["batch"], plen + SERVE_REQ["gen"]),
                       dtype=torch.int64)
    for i, r in enumerate(reqs):
        toks[i, plen - len(prompts[r]):plen] = torch.from_numpy(
            prompts[r].astype("int64"))
        toks[i, plen:] = torch.tensor(cpu["outputs"][r])
    logits = {}
    serve_step = make_serve_step(cfg)
    for where, d, p in (("cpu", torch.device("cpu"), cpu_params),
                        ("card", dev, params)):
        cache = transformer.init_cache(cfg, SERVE_REQ["batch"],
                                       SERVE_REQ["prompt_len"]
                                       + SERVE_REQ["gen"] + 1, torch.float32,
                                       device=d)
        t = toks.to(d)
        for i in range(plen + step):
            out, cache = serve_step(p, cache, t[:, i:i + 1])
        logits[where] = out[:, 0].cpu()
    row = reqs.index(rid)
    top2 = torch.topk(logits["cpu"][row], 2).values
    gap = float(top2[0] - top2[1])
    ldiff = float((logits["card"][row] - logits["cpu"][row]).abs().max())
    log(f"  {label}: ServeLoop tokens differ from the CPU's in "
        f"{len(diff)} requests, first request {rid} at step {step}: the "
        f"CPU's top-2 logit gap there {gap:.3e}, card-vs-CPU logit diff "
        f"{ldiff:.3e}")
    if not gap < ldiff:
        raise AssertionError(f"{label}: ServeLoop tokens differ from the "
                             f"CPU's where no near-tie explains it")


def check_serve_kernels(dev, seen: dict) -> tuple[dict, list]:
    """B4 and B5 against their plain versions at every shape the serve
    phase gave them, and B5 from an entering state; B4 timed against its
    plain version, ``scaled_dot_product_attention`` and its bound at each
    new head layout, B5 at the hybrid's shape; then B6 and B1/B2 at
    phi4-mini's vocabulary.  Returns (max abs error by kernel, table rows)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.kd_kl import ops as kd_ops
    from repro_torch.kernels.kd_kl import ref as kd_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.launch import roofline as rl

    gen = torch.Generator(device=dev).manual_seed(11)
    err, rows = {}, []
    for qs, ks, causal, window in sorted(
            {key[:4] for key in shapes(seen, "flash_attention_fwd")}, key=str):
        q = torch.randn(qs, device=dev, generator=gen)
        k = torch.randn(ks, device=dev, generator=gen)
        v = torch.randn(ks, device=dev, generator=gen)
        want = fa_ref.attention_ref(q, k, v, causal=causal, window=window)
        e = compare(f"flash_attention_fwd q{qs} k{ks} window {window}",
                    fa_ops.flash_attention_fwd(q, k, v, causal, window), want)
        err["flash_attention_fwd"] = max(err.get("flash_attention_fwd", 0.0),
                                         e)
        b, s, hq, d = qs
        hkv = ks[2]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = fa_ref.causal_mask(s, s, window=window, device=dev)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=hkv != hq)

        lib_err = float((library().transpose(1, 2) - want).abs().max())
        t = dict(ms=time_ms(lambda: fa_ops.flash_attention_fwd(
                     q, k, v, causal, window), reps=5, replays=4),
                 plain_ms=time_ms(lambda: fa_ref.attention_ref(
                     q, k, v, causal=causal, window=window), reps=2,
                     replays=2),
                 library_ms=time_ms(library, reps=5, replays=4))
        t.update(rl.tf32x3_bound_ms(*rl.flash_cost(b, s, s, hq, hkv, d,
                                                   causal, window)[:2]))
        log(f"  flash {qs} kv {ks} window {window}: err {e:.2e} kernel "
            f"{t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms sdpa "
            f"{t['library_ms']:.4f} ms (err {lib_err:.2e}) bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}; fp32 "
            f"{t['fp32_bound_ms']:.4f})")
        rows.append(dict(name="flash_attention_fwd", shape=(qs, ks, window),
                         **t))
    for xs, bs, chunk, from_state in sorted(shapes(seen, "ssd_scan_fwd"),
                                            key=str) + [
            (SERVE_SSD_INIT[0], SERVE_SSD_INIT[1], SERVE_SSD_INIT[2], True)]:
        b, l, h, p = xs
        g, n = bs[2], bs[3]
        args = ssd_inputs(dev, gen, b, l, h, p, g, n)
        init = (torch.randn(b, h, p, n, device=dev, generator=gen)
                if from_state else None)
        got = ssd_ops.ssd_scan_fwd(*args, chunk, init)
        want = ssd_ref.ssd_scan_ref(*args, chunk, init)
        exact = ssd_ref.ssd_chunked(*(t.double() for t in args), chunk=chunk,
                                    init_state=(None if init is None
                                                else init.double()))
        line = f"  ssd x{xs} B{bs} chunk {chunk} entering state {from_state}:"
        for name, a, w, ex in zip(("y", "state"), got, want, exact):
            e = float((a - w).abs().max())
            if not e <= KERNEL_TOL * max(float(w.abs().max()), 1e-30):
                ek = float((a.double() - ex).abs().max())
                ep = float((w.double() - ex).abs().max())
                if not ek <= ep:
                    raise AssertionError(f"ssd_scan_fwd x{xs} init "
                                         f"{from_state}: {name} {e:.3e} from "
                                         f"plain, {ek:.3e} from float64 "
                                         f"(plain {ep:.3e})")
                line += f" {name} vs float64 {ek:.3e} (plain {ep:.3e});"
            line += f" {name} err {e:.3e};"
            err["ssd_scan_fwd"] = max(err.get("ssd_scan_fwd", 0.0), e)
        if (xs, bs, chunk) == SERVE_SSD_TIMED:
            t = dict(ms=time_ms(lambda: ssd_ops.ssd_scan_fwd(*args, chunk),
                                reps=5, replays=4),
                     plain_ms=time_ms(lambda: ssd_ref.ssd_scan_ref(
                         *args, chunk), reps=2, replays=2), library_ms=None)
            t.update(rl.tf32x3_bound_ms(*rl.ssd_cost(b, l, h, p, g, n,
                                                     chunk)[:2]))
            line += (f" kernel {t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms "
                     f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}; fp32 "
                     f"{t['fp32_bound_ms']:.4f})")
            rows.append(dict(name="ssd_scan_fwd", shape=(xs, bs, chunk), **t))
        log(line)
    # B6 and B1/B2 at phi4-mini's vocabulary, a row of 800 KB
    rows_n, vocab = SERVE_KD_ROWS, SERVE_VOCAB
    lt = torch.randn(rows_n, vocab, device=dev, generator=gen) * 2
    ls = torch.randn(rows_n, vocab, device=dev, generator=gen) * 2
    g = torch.randn(rows_n, device=dev, generator=gen)
    err["row_logsumexp"] = compare(f"row_logsumexp ({rows_n}, {vocab})",
                                   kd_ops.row_lse_fwd(ls, 1.0),
                                   kd_ref.row_logsumexp_ref(ls, 1.0))
    kl, lse_t, lse_s = kd_ops.kd_kl_fwd(lt, ls, 1.0)
    want = kd_ref.kd_kl_fwd_ref(lt, ls, 1.0)
    err["kd_kl_fwd"] = max(compare(f"kd_kl_fwd ({rows_n}, {vocab}):{nm}", a, w)
                           for nm, a, w in zip(("kl", "lse_t", "lse_s"),
                                               (kl, lse_t, lse_s), want))
    err["kd_kl_bwd"] = compare(
        f"kd_kl_bwd ({rows_n}, {vocab})",
        kd_ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, 1.0),
        kd_ref.kd_kl_bwd_ref(lt, ls, lse_t, lse_s, g, 1.0))
    timed = [
        ("row_logsumexp", lambda: kd_ops.row_lse_fwd(ls, 1.0),
         lambda: kd_ref.row_logsumexp_ref(ls, 1.0),
         lambda: torch.logsumexp(ls, -1),
         rl.row_lse_cost(rows_n, vocab).bound()),
        ("kd_kl_fwd", lambda: kd_ops.kd_kl_fwd(lt, ls, 1.0),
         lambda: kd_ref.kd_kl_fwd_ref(lt, ls, 1.0),
         lambda: F.kl_div(F.log_softmax(ls, -1), F.log_softmax(lt, -1),
                          reduction="none", log_target=True).sum(-1),
         rl.kd_kl_fwd_cost(rows_n, vocab).bound()),
        ("kd_kl_bwd", lambda: kd_ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, 1.0),
         lambda: kd_ref.kd_kl_bwd_ref(lt, ls, lse_t, lse_s, g, 1.0), None,
         rl.kd_kl_bwd_cost(rows_n, vocab).bound())]
    for name, kern, plain, lib, (bnd, by) in timed:
        t = dict(ms=time_ms(kern, reps=5, replays=4),
                 plain_ms=time_ms(plain, reps=2, replays=2),
                 library_ms=time_ms(lib, reps=2, replays=2) if lib else None,
                 bound_ms=bnd, bound_by=by)
        lib_s = f"{t['library_ms']:.4f}" if lib else "none"
        log(f"  {name} ({rows_n}, {vocab}): err {err[name]:.2e} kernel "
            f"{t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms library {lib_s} "
            f"ms bound {bnd:.4f} ms ({by}), {bnd / t['ms']:.3f} of it")
        rows.append(dict(name=name, shape=(rows_n, vocab), **t))
    return err, rows


def run_serve(dev) -> tuple[dict, dict]:
    """The LM serve path at published widths in fp32 (``serve_runs``) with
    the launch counts set to 0 just before and read just after, then B4 and
    B5 held to their plain versions at the shapes it gave them
    (``check_serve_kernels``).  Returns (launch counts, max abs errors)."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.init()
    t0 = time.perf_counter()
    with record_shapes() as seen:
        reset_launches()
        serve_runs(dev)
        launches = dict(LAUNCHES)
    log(f"serve: launches {launches}")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serve path: "
                             f"{missing}")
    torch.cuda.empty_cache()
    err, _ = check_serve_kernels(dev, seen)
    log(f"serve phase: {time.perf_counter() - t0:.1f} s; max abs err {err}")
    return launches, err


def serve_runs(dev) -> None:
    """phi4-mini (depth 32 -> 2): one FedGKD round of ``run_serial``, a
    prefill of the last position from its params, then from a fresh init
    ``ServeLoop``, decode against forward, the sliding-window ring buffer;
    mamba2-2.7b (``lm_config(4)``) and zamba2-1.2b (depth 38 -> 6, one
    shared-block application):
    ``ServeLoop`` and decode against forward, zamba2's prefill; minitron-4b,
    granite-34b and internlm2-20b (depth -> 1): a forward and 8 decode
    steps against it; each ``ServeLoop``'s tokens against the CPU's."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.train import run_serial
    from repro_torch.models import transformer

    # phi4-mini: FedGKD, then serving from the trained params
    cfg = serve_config("phi4-mini-3.8b", SERVE_PHI_LAYERS)
    log(f"serve, phi4-mini-3.8b: d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}, {cfg.param_count():,} params; cuts: "
        f"{serve_cuts(cfg)}; FedGKD {SERVE_FL}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with card_weights(dev):
        out = run_serial(cfg, rounds=1, algo="fedgkd", device=dev,
                         verbose=False, **SERVE_FL)
    r = out["history"][0]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"  FedGKD round: {r['seconds']:.3f} s, ppl {r['ppl']:.6g}, loss "
        f"{r['loss']:.6f}, kd {r['kd']:.6e}; peak device memory {peak:.2f} "
        f"GiB (limit {SERVE_PEAK_GIB})")
    if not (math.isfinite(r["loss"]) and math.isfinite(r["kd"])
            and all_finite(out["params"])):
        raise AssertionError("phi4-mini FedGKD: non-finite loss or params")
    if not peak < SERVE_PEAK_GIB:
        raise AssertionError(f"phi4-mini FedGKD: peak {peak:.2f} GiB")
    params = out["params"]
    del out
    gen = torch.Generator(device=dev).manual_seed(8)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, SERVE_PREFILL,
                                     device=dev, generator=gen)}
    prefill = steps.make_prefill_step(cfg, last_only=True)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    last = prefill(params, batch)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    one = {"tokens": batch["tokens"][:1]}
    full = steps.make_prefill_step(cfg)(params, one)
    e = float((last[:1] - full[:, -1:]).abs().max())
    log(f"  prefill (last_only) of {SERVE_PREFILL}: {ms:.1f} ms, logits "
        f"{tuple(last.shape)}; against the full prefill's last position "
        f"{e:.3e}")
    if not (tuple(last.shape) == (SERVE_PREFILL[0], 1, cfg.vocab_size)
            and all_finite(last) and e <= KERNEL_TOL * float(
                full.abs().max())):
        raise AssertionError("phi4-mini prefill: wrong shape, non-finite, or "
                             "off the full prefill")
    del full, last, params
    torch.cuda.empty_cache()
    # serving from a fresh init, as the serve CLI does
    params = card_init(cfg, dev)
    serve_arch("phi4-mini-3.8b", cfg, params, dev,
               check=(serve_config("phi4-mini-3.8b", 1), None))
    wcfg = cfg.replace(attn_window=SERVE_WINDOW)
    gen = torch.Generator(device=dev).manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (1, SERVE_RING_TOKENS),
                         device=dev, generator=gen)
    cache = transformer.init_cache(wcfg, 1, SERVE_RING_TOKENS, torch.float32,
                                   device=dev)
    serve_step = steps.make_serve_step(wcfg)
    outs = []
    for i in range(SERVE_RING_TOKENS):
        lg, cache = serve_step(params, cache, toks[:, i:i + 1])
        outs.append(lg[:, 0])
    with torch.no_grad():
        full, _ = transformer.forward(params, wcfg, toks)
    against_forward(f"phi4-mini-3.8b ring buffer: window {SERVE_WINDOW} "
                    f"(a ring of {cache['seg0'].k.shape[2]} slots) over "
                    f"{SERVE_RING_TOKENS} tokens", torch.stack(outs, 1), full)
    del params, full, outs, cache
    torch.cuda.empty_cache()

    for arch, n_layers in (("mamba2-2.7b", LM_LAYERS),
                           ("zamba2-1.2b", SERVE_ZAMBA_LAYERS)):
        cfg = serve_config(arch, n_layers)
        log(f"serve, {arch}: d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
            f"{cfg.param_count():,} params; cuts: {serve_cuts(cfg)}")
        params = card_init(cfg, dev)
        if arch == "zamba2-1.2b":
            batch = {"tokens": torch.randint(0, cfg.vocab_size, SERVE_PREFILL,
                                             device=dev, generator=gen)}
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            last = steps.make_prefill_step(cfg, last_only=True)(params, batch)
            torch.cuda.synchronize(dev)
            log(f"  prefill (last_only) of {SERVE_PREFILL}: "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
            if not all_finite(last):
                raise AssertionError(f"{arch} prefill: non-finite logits")
        serve_arch(arch, cfg, params, dev, check=(cfg, params))
        del params
        torch.cuda.empty_cache()

    for arch in ("minitron-4b", "granite-34b", "internlm2-20b"):
        cfg = serve_config(arch, 1)
        log(f"serve, {arch}: d_model {cfg.d_model}, heads "
            f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, vocab "
            f"{cfg.vocab_size}, {cfg.norm}/{cfg.act}, tied "
            f"{cfg.tie_embeddings}, {cfg.param_count():,} params; cuts: "
            f"{serve_cuts(cfg)}")
        params = card_init(cfg, dev)
        decode_vs_forward(arch, cfg, params, dev, SERVE_DECODE_PROMPT,
                          SERVE_DECODE_STEPS)
        del params
        torch.cuda.empty_cache()


def serve_arch(arch, cfg, params, dev, check) -> None:
    """``ServeLoop`` with ``SERVE_REQ``'s traffic (tokens/s, seconds; then
    the same run profiled), its greedy decode against the forward, and its
    tokens against the CPU's at ``check`` = (config, params or None for a
    fresh card init)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import make_prompts

    prompts = make_prompts(SERVE_REQ["requests"], cfg.vocab_size,
                           SERVE_REQ["prompt_len"])
    stats = serve_on(cfg, params, prompts, dev)
    log(f"  ServeLoop: {SERVE_REQ['requests']} requests, batch "
        f"{SERVE_REQ['batch']}, prompts {sorted(len(p) for p in prompts)}, "
        f"{SERVE_REQ['gen']} generated: {stats['seconds']:.4f} s, "
        f"{stats['decode_steps']} decode steps, {stats['tok_per_s']:.2f} "
        f"tok/s")
    # the same run again under the profiler: how much of it the card works
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = serve_on(cfg, params, prompts, dev)
    device_busy(prof, f"{arch} ServeLoop, a second run", again["seconds"]
                * 1e3, top=6)
    decode_vs_forward(arch, cfg, params, dev, SERVE_DECODE_PROMPT,
                      SERVE_DECODE_STEPS)
    ccfg, cparams = check
    if cparams is None:
        cparams = card_init(ccfg, dev, seed=1)
        stats = serve_on(ccfg, cparams, prompts, dev)
    serve_tokens_vs_cpu(f"{arch} ({ccfg.n_layers} layers)", ccfg, cparams,
                        prompts, stats, dev)


# ---------------------------------------------------------------------------
# the bf16 phase: the LM trainer and serving at the published dtype
# ---------------------------------------------------------------------------

def bf16_compare(name: str, got, want) -> float:
    """``got`` (bf16) within one bf16 ulp of ``want`` (fp32, the plain
    version on the same values upcast) rounded to bf16, plus the fp32 bar
    (KERNEL_TOL of max|want|: a kernel's fp32 value may sit across a
    rounding boundary from the plain version's by its fp32 error); raises
    past it, returns max |got - want|."""
    import torch

    if got.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: {got.dtype}, not bf16")
    w = want.to(torch.bfloat16).to(torch.float32)
    _, e = torch.frexp(w)
    ulp = torch.where(w != 0, torch.ldexp(torch.ones_like(w), e - 8),
                      torch.zeros_like(w))
    over = ((got.float() - w).abs() - ulp
            - KERNEL_TOL * float(want.abs().max())).max()
    if not float(over) <= 0.0:
        raise AssertionError(f"{name}: {float(over):.3e} past one bf16 ulp "
                             f"of the plain version")
    return float((got.float() - want).abs().max())


def bf16_parity(label: str, port, cpu_bf16, cpu_fp32,
                gate: bool = True) -> float:
    """The CPU parity tests' bar (tests/test_torch_bf16.py), leaf for leaf:
    the card's bf16 result no further from the CPU's fp32 one than twice
    the CPU's bf16 result is, or one bf16 ulp of the leaf's magnitude; the
    dtypes equal.  Returns the largest ratio of the card's distance to its
    bar; past the bar it raises, unless ``gate`` is false (a reading)."""
    from repro_torch.tree import tree_leaves

    worst = 0.0
    for a, b, f in zip(tree_leaves(port), tree_leaves(cpu_bf16),
                       tree_leaves(cpu_fp32), strict=True):
        if a.dtype != b.dtype:
            raise AssertionError(f"{label}: dtype {a.dtype} vs the CPU's "
                                 f"{b.dtype}")
        a, b, f = (t.detach().float().cpu() for t in (a, b, f))
        e_card, e_cpu = float((a - f).abs().max()), float((b - f).abs().max())
        bar = max(2 * e_cpu, 2.0 ** -8 * float(f.abs().max()))
        worst = max(worst, e_card / bar if bar else 0.0)
        if gate and not e_card <= bar:
            raise AssertionError(f"{label}: card {e_card:.3e} from the CPU's "
                                 f"fp32, CPU bf16 {e_cpu:.3e}, bar {bar:.3e}")
    return worst


def ptxas_of(kernel: str) -> list[str]:
    """The build log's ``ptxas`` lines (registers, spills) of each
    compiled kernel whose mangled name holds ``kernel``."""
    from repro_torch.kernels import build

    out, hit = [], False
    for line in build.BUILD_LOG.get("ptxas", "").splitlines():
        if "Compiling entry" in line:
            hit = kernel in line
            if hit:
                out.append(line.split("'")[1])
        elif hit and ("Used" in line or "spill" in line):
            out.append("  " + line.split(":", 1)[-1].strip())
    return out


def attention_f64(q, k, v, window=None):
    """Causal attention in float64 throughout (``ref.attention_ref`` takes
    its logits and softmax in fp32 whatever the inputs' dtype)."""
    import torch

    from repro_torch.kernels.flash_attention import ref

    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.double().reshape(b, s, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) / math.sqrt(d)
    sees = ref.causal_mask(s, k.shape[1], window=window, device=q.device)
    p = logits.masked_fill(~sees, -math.inf).softmax(-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.double()).reshape(
        b, s, hq, d)


def check_bf16_kernels(dev) -> list[dict]:
    """The kernels' bf16 forms against their plain versions, timed:
    B4 at ``BF16_FLASH`` (the fp32 plain version on the inputs upcast, to
    one bf16 ulp; the bf16 plain version, which rounds P, at the
    reference's 2e-2; at the first shape also a float64 attention, read:
    the largest error and the outputs that are not its bf16 rounding; the
    library call is sdpa in bf16, with the boolean mask and, where there
    is no window, with ``is_causal``, which can take the flash backend:
    the faster of the two is ``library_ms``, both logged; its ``ptxas``
    registers and spills from the build log); B1, B2 and B6 at
    ``BF16_KD`` (kl and the logsumexps at the fp32 bar, B2's bf16 dls to
    one ulp); B5's casting wrapper, which runs the fp32 kernels, at
    zamba2's prefill (y to one ulp, the fp32 state at the fp32 bar; its
    time is logged as the wrapper's and is no entry of the kernels line).
    Bounds count 2 bytes per bf16 element; B4's its bf16 tensor-core
    arithmetic (``roofline.bf16_flash_bound_ms``), the wrapper's its FLOP
    at the bf16 peak.  Returns the JSON entries, timed at the first shape of each
    list."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.kd_kl import ops as kd_ops
    from repro_torch.kernels.kd_kl import ref as kd_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.launch import roofline as rl

    gen = torch.Generator(device=dev).manual_seed(22)
    entries = {}
    for line in ptxas_of("flash_fwd_bf16_kernel"):
        log(f"  ptxas: {line}")
    for b, s, hq, hkv, d, window in BF16_FLASH:
        q = torch.randn(b, s, hq, d, device=dev, generator=gen).bfloat16()
        k, v = (torch.randn(b, s, hkv, d, device=dev, generator=gen)
                .bfloat16() for _ in range(2))
        got = fa_ops.flash_attention_fwd(q, k, v, True, window)
        want = fa_ref.attention_ref(q.float(), k.float(), v.float(),
                                    window=window)
        err = bf16_compare(f"flash_attention_fwd_bf16 {q.shape}", got, want)
        plain = fa_ref.attention_ref(q, k, v, window=window).float()
        e_plain = float((got.float() - plain).abs().max())
        if not bool(((got.float() - plain).abs()
                     <= BF16_FLASH_TOL * (1 + plain.abs())).all()):
            raise AssertionError(f"flash bf16 {tuple(q.shape)}: {e_plain} "
                                 f"from the bf16 plain version")
        if not entries:
            exact = attention_f64(q, k, v, window)
            rounded = exact.to(torch.bfloat16).double()
            flips = int((got.double() != rounded).sum())
            flips_plain = int((want.to(torch.bfloat16).double()
                               != rounded).sum())
            log(f"  flash bf16 {tuple(q.shape)} against float64: max err "
                f"{float((got.double() - exact).abs().max()):.3e} (the fp32 "
                f"plain version "
                f"{float((want.double() - exact).abs().max()):.3e}); {flips} "
                f"of {got.numel()} outputs not float64's bf16 rounding (the "
                f"fp32 plain version rounded: {flips_plain})")
            del exact, rounded
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = fa_ref.causal_mask(s, s, window=window, device=dev)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=hkv != hq)

        def library_causal():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=hkv != hq)

        t = dict(ms=time_ms(lambda: fa_ops.flash_attention_fwd(
                     q, k, v, True, window), reps=5, replays=4),
                 plain_ms=time_ms(lambda: fa_ref.attention_ref(
                     q, k, v, window=window), reps=2, replays=2))
        lib = {"mask": time_ms(library, reps=5, replays=4)}
        if window is None or window >= s:      # the same function: causal
            lib["is_causal"] = time_ms(library_causal, reps=5, replays=4)
        t["library_ms"] = min(lib.values())
        t.update(rl.bf16_flash_bound_ms(*rl.flash_cost(
            b, s, s, hq, hkv, d, True, window, elt=2)[:2]))
        lib_s = ", ".join(f"{k_} {ms:.4f}" for k_, ms in lib.items())
        log(f"  flash bf16 (B={b}, S={s}, Hq={hq}, Hkv={hkv}, D={d}, window "
            f"{window}): err {err:.2e} (bf16 plain {e_plain:.2e}) kernel "
            f"{t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms sdpa bf16 "
            f"({lib_s}) ms bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}; 3xTF32 {t['tf32x3_bound_ms']:.4f}), "
            f"{t['bound_ms'] / t['ms']:.3f} of it")
        rec = entries.setdefault("flash_attention_fwd_bf16", dict(
            max_abs_err=0.0, **t))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    for rows, vocab in BF16_KD:
        lt, ls = ((torch.randn(rows, vocab, device=dev, generator=gen) * 2)
                  .bfloat16() for _ in range(2))
        g = torch.randn(rows, device=dev, generator=gen)
        lt32, ls32 = lt.float(), ls.float()
        kl, lse_t, lse_s = kd_ops.kd_kl_fwd(lt, ls, 1.0)
        want = kd_ref.kd_kl_fwd_ref(lt32, ls32, 1.0)
        errs = {"kd_kl_fwd_bf16": max(
            compare(f"kd_kl_fwd_bf16 ({rows}, {vocab}):{nm}", a, w)
            for nm, a, w in zip(("kl", "lse_t", "lse_s"), (kl, lse_t, lse_s),
                                want)),
            "kd_kl_bwd_bf16": bf16_compare(
                f"kd_kl_bwd_bf16 ({rows}, {vocab})",
                kd_ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, 1.0),
                kd_ref.kd_kl_bwd_ref(lt32, ls32, lse_t, lse_s, g, 1.0)),
            "row_logsumexp_bf16": compare(
                f"row_logsumexp_bf16 ({rows}, {vocab})",
                kd_ops.row_lse_fwd(ls, 1.0),
                kd_ref.row_logsumexp_ref(ls32, 1.0))}
        timed = {
            "row_logsumexp_bf16": (
                lambda: kd_ops.row_lse_fwd(ls, 1.0),
                lambda: kd_ref.row_logsumexp_ref(ls, 1.0),
                lambda: torch.logsumexp(ls, -1),
                rl.row_lse_cost(rows, vocab, 2).bound()),
            "kd_kl_fwd_bf16": (
                lambda: kd_ops.kd_kl_fwd(lt, ls, 1.0),
                lambda: kd_ref.kd_kl_fwd_ref(lt, ls, 1.0),
                lambda: F.kl_div(F.log_softmax(ls, -1), F.log_softmax(lt, -1),
                                 reduction="none", log_target=True).sum(-1),
                rl.kd_kl_fwd_cost(rows, vocab, 2).bound()),
            "kd_kl_bwd_bf16": (
                lambda: kd_ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, 1.0),
                lambda: kd_ref.kd_kl_bwd_ref(lt, ls, lse_t, lse_s, g, 1.0),
                None, rl.kd_kl_bwd_cost(rows, vocab, 2).bound())}
        for name, (kern, plain, lib, (bnd, by)) in timed.items():
            t = dict(ms=time_ms(kern, reps=5, replays=4),
                     plain_ms=time_ms(plain, reps=2, replays=2),
                     library_ms=time_ms(lib, reps=2, replays=2) if lib
                     else None, bound_ms=bnd, bound_by=by)
            lib_s = f"{t['library_ms']:.4f}" if lib else "none"
            log(f"  {name} ({rows}, {vocab}): err {errs[name]:.2e} kernel "
                f"{t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms library "
                f"{lib_s} ms bound {bnd:.4f} ms ({by}), {bnd / t['ms']:.3f} "
                f"of it")
            rec = entries.setdefault(name, dict(max_abs_err=0.0, **t))
            rec["max_abs_err"] = max(rec["max_abs_err"], errs[name])
    (b, l, h, p), (_, _, g, n), chunk = SERVE_SSD_TIMED
    x, dt, a, bm, cm = ssd_inputs(dev, gen, b, l, h, p, g, n)
    x, bm, cm = (t.bfloat16() for t in (x, bm, cm))
    y, state = ssd_ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    args = (x.float(), dt, a, bm.float(), cm.float())
    want = ssd_ref.ssd_scan_ref(*args, chunk)
    exact = ssd_ref.ssd_chunked(*(t.double() for t in args), chunk=chunk)
    err = bf16_compare(f"ssd_scan wrapper, bf16 x{tuple(x.shape)}: y", y,
                       want[0])
    e_state = float((state - want[1]).abs().max())
    if not e_state <= KERNEL_TOL * float(want[1].abs().max()) and not (
            (state.double() - exact[1]).abs().max()
            <= (want[1].double() - exact[1]).abs().max()):
        raise AssertionError(f"ssd_scan wrapper, bf16: state {e_state:.3e}")
    t = dict(ms=time_ms(lambda: ssd_ops.ssd_scan(x, dt, a, bm, cm,
                                                 chunk=chunk), reps=5,
                        replays=4),
             plain_ms=time_ms(lambda: ssd_ref.ssd_scan_ref(
                 x.float(), dt, a, bm.float(), cm.float(), chunk).__getitem__(
                 0).bfloat16(), reps=2, replays=2),
             bound=rl.ssd_cost(b, l, h, p, g, n, chunk, elt=2).bound(
                 rl.PEAK_BF16))
    log(f"  ssd bf16 wrapper (casts around the fp32 kernels) x{tuple(x.shape)}"
        f" B{tuple(bm.shape)} chunk {chunk}: y err {err:.2e} state err "
        f"{e_state:.2e} wrapper {t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms"
        f" bound {t['bound'][0]:.4f} ms ({t['bound'][1]}, FLOP at the bf16 "
        f"peak)")
    where = {"flash_attention_fwd_bf16": ("flash_attention_bf16.cu",
                                          "flash_attention/kernel.py:28"),
             "kd_kl_fwd_bf16": ("kd_kl.cu", "kd_kl/kernel.py:33"),
             "kd_kl_bwd_bf16": ("kd_kl.cu", "kd_kl/kernel.py:113"),
             "row_logsumexp_bf16": ("kd_kl.cu", "kd_kl/kernel.py:148")}
    return [dict(name=name, route="cuda",
                 source=f"src/repro_torch/csrc/{where[name][0]}",
                 replaces=f"src/repro/kernels/{where[name][1]}", **rec)
            for name, rec in entries.items()]


def smoke_round_vs_cpu(arch: str, dev, run: dict, gate: bool = True,
                       variant=None) -> tuple[float, dict]:
    """Round 1 of ``arch``'s smoke config (``variant(cfg)`` where given) in
    bf16 through ``run_serial`` on the card, against the same round on the
    CPU in bf16 and in fp32 from the same bf16 init upcast, under
    ``bf16_parity``: (the worst ratio to the bar, the card run's launch
    counts)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import run_serial
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    scfg = (variant or (lambda c: c))(get_smoke_config(arch)).replace(
        param_dtype="bfloat16", activation_dtype="bfloat16")
    init = transformer.init(torch.Generator().manual_seed(0), scfg)
    rounds, launches = {}, {}
    real_init = transformer.init
    try:
        for where, c, d in (("card", scfg, dev), ("cpu", scfg, "cpu"),
                            ("cpu fp32", fp32_of(scfg), "cpu")):
            transformer.init = lambda gen, c_, c=c: tree_map(
                lambda t: t.to(c.pdtype) if t.dtype == torch.bfloat16 else t,
                init)
            reset_launches()
            rounds[where] = run_serial(c, rounds=1, algo="fedgkd", device=d,
                                       verbose=False, **run)
            if where == "card":
                launches = dict(LAUNCHES)
    finally:
        transformer.init = real_init
    name = arch if variant is None else f"{arch} ({variant.__name__})"
    worst = bf16_parity(f"bf16 {name} round 1, card against CPU",
                        rounds["card"]["params"], rounds["cpu"]["params"],
                        rounds["cpu fp32"]["params"], gate=gate)
    loss = {k: r["history"][0]["loss"] for k, r in rounds.items()}
    log(f"  round 1 of the smoke {name} in bf16 ({run}): card at {worst:.3f} "
        f"of the bar (2 x the CPU bf16 run's distance to its fp32 run)"
        f"{'' if gate else ', a reading'}; losses card {loss['card']:.6f} "
        f"CPU {loss['cpu']:.6f} fp32 {loss['cpu fp32']:.6f}")
    return worst, launches


def step_peak_gate(label: str, cfg, dev) -> dict:
    """One FedGKD train step on the card against the dry-run's prediction
    of it (``launch.dryrun_lib``: the step traced on the meta device).
    The step is the dry-run's (``dryrun_lib.make_train_step``: SGD with
    momentum 0.9 and weight decay 1e-5, the teacher a parameter tree of its
    own) on the phase's batch, ``BF16_FL``'s 2 x 1,024 tokens; params,
    teacher and optimizer state drawn on the card and resident.  After a
    warm-up step, ``torch.cuda.max_memory_allocated()`` over the step less
    the bytes allocated before it is held to the prediction's
    ``temp_size_in_bytes``: the ratio within ``STEP_PEAK_BAND`` or the run
    fails.  The step's wall time is printed beside the dry-run's
    ``bound_time_s`` and its share of the bf16 peak, model FLOPs over
    time, for the record.  Returns the figures."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import roofline as rl

    shape = InputShape(label, BF16_FL["seq"] - 1, BF16_FL["batch"], "train")
    step = dryrun_lib.make_train_step(cfg)
    _, pred = dryrun_lib.trace(step, dryrun_lib.train_arguments(cfg, shape))
    model_flops = dryrun_lib.step_model_flops(cfg, shape, "teacher")
    report = rl.RooflineReport(label, shape.name, rl.MESH, 1, pred.flops,
                               pred.bytes_accessed, 0.0, model_flops,
                               dtype=dryrun_lib.dtype_name(cfg))
    torch.cuda.empty_cache()
    params = card_init(cfg, dev)
    teacher = card_init(cfg, dev, seed=1)
    opt_state = dryrun_lib.OPT.init(params)
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab_size, (shape.global_batch,
                                                  shape.seq_len),
                              device=dev, generator=gen, dtype=torch.int32)
             for k in ("tokens", "labels")}
    step(params, teacher, opt_state, batch)        # warm-up, discarded
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out = step(params, teacher, opt_state, batch)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    measured = torch.cuda.max_memory_allocated(dev) - resident
    del out, params, teacher, opt_state, batch
    torch.cuda.empty_cache()
    predicted = pred.memory["temp_size_in_bytes"]
    ratio = measured / predicted
    rec = dict(label=label, measured_gib=measured / 2 ** 30,
               predicted_gib=predicted / 2 ** 30, ratio=ratio,
               resident_gib=resident / 2 ** 30,
               predicted_args_gib=pred.memory["argument_size_in_bytes"]
               / 2 ** 30, wall_s=wall, bound_time_s=report.bound_time_s,
               dominant=report.dominant,
               mfu=model_flops / (wall * rl.PEAK_BF16))
    log(f"  step peak, {label} (one FedGKD step of {shape.global_batch} x "
        f"{shape.seq_len} tokens): {rec['measured_gib']:.3f} GiB on the "
        f"card beyond {rec['resident_gib']:.3f} GiB resident, the dry-run "
        f"predicts {rec['predicted_gib']:.3f} GiB (arguments "
        f"{rec['predicted_args_gib']:.3f} GiB): ratio {ratio:.4f} (band "
        f"{STEP_PEAK_BAND}); the step {wall:.4f} s, dry-run bound "
        f"{report.bound_time_s:.4f} s ({report.dominant}), model FLOPs "
        f"{model_flops:.4e} over the time at the bf16 peak "
        f"{rec['mfu']:.4f}")
    if not STEP_PEAK_BAND[0] <= ratio <= STEP_PEAK_BAND[1]:
        raise AssertionError(f"{label}: step peak {measured} bytes against "
                             f"the dry-run's {predicted}: ratio {ratio:.4f} "
                             f"outside {STEP_PEAK_BAND}")
    return rec


def bf16_config(arch: str, n_layers: int):
    """``arch`` at its published width and dtypes (bf16), depth cut to
    ``n_layers``."""
    from repro_torch.configs import get_config

    return get_config(arch).replace(n_layers=n_layers)


def fp32_of(cfg):
    return cfg.replace(param_dtype="float32", activation_dtype="float32")


def run_bf16(dev) -> tuple[dict, list]:
    """The kernels' bf16 forms (``check_bf16_kernels``), then the bf16 main
    paths (``bf16_runs``) with every launch count set to 0 just before and
    read just after each run.  Returns (launch counts, the bf16 kernels'
    JSON entries)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    entries = check_bf16_kernels(dev)
    launches = bf16_runs(dev)
    log(f"bf16 phase: {time.perf_counter() - t0:.1f} s; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    return launches, entries


def bf16_fl(label, cfg, dev, run, rounds) -> tuple[dict, dict, float]:
    """``rounds`` FedGKD rounds of ``run_serial`` on the card from a card
    init, the launch counts set to 0 just before and read just after,
    then round 2 of another 2 rounds profiled (``profile_round``): (the
    run's output, the launch counts, peak GiB)."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import run_serial
    from repro_torch.tree import tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with card_weights(dev):
        reset_launches()
        out = run_serial(cfg, rounds=rounds, algo="fedgkd", device=dev,
                         verbose=False, **run)
        launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    for r in out["history"]:
        log(f"  {label} round {r['round']}: {r['seconds']:.3f} s ppl "
            f"{r['ppl']:.6g} loss {r['loss']:.6f} kd {r['kd']:.6e}")
    log(f"  {label}: peak device memory {peak:.2f} GiB, launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    values = [v for r in out["history"] for v in (r["loss"], r["kd"])]
    if not (all(map(math.isfinite, values)) and all_finite(out["params"])):
        raise AssertionError(f"{label}: non-finite loss or params")
    out["dtypes"] = sorted({str(t.dtype) for t in
                            tree_leaves(out.pop("params"))})
    with card_weights(dev):
        profile_round(dev, label, lambda cb: run_serial(
            cfg, rounds=2, algo="fedgkd", device=dev, verbose=False,
            round_callback=cb, **run))
    return out, launches, peak


def bf16_runs(dev) -> dict:
    """phi4-mini in bf16 at depth 8: ``BF16_ROUNDS`` FedGKD rounds (B4 in
    bf16, B6, B1 and B2 launched; KD non-zero in round 2; peak GiB), the
    same rounds in fp32 for comparison, and round 1 of the smoke config on
    the card against the CPU's (``bf16_parity``); phi4-mini unchanged (32
    layers, bf16): a last-position prefill, ``ServeLoop``, greedy decode
    against the forward under ``bf16_parity``'s bar, ``ServeLoop``'s tokens
    against the CPU's at 1 layer; mamba2 in bf16 at depth 4, one round
    beside the LM phase's fp32 rounds, and its smoke round against the
    CPU's (``smoke_round_vs_cpu``); ``run_sharded`` on the card twice
    over against ``run_serial`` at depth 2.  Returns the launch counts of
    the card's runs."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.train import run_serial, run_sharded
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    total = dict.fromkeys(LAUNCHES, 0)

    def add(counts):
        for k, n in counts.items():
            total[k] += n

    # phi4-mini at depth 8, bf16 as published, then fp32
    cfg = bf16_config("phi4-mini-3.8b", BF16_PHI_LAYERS)
    log(f"bf16, phi4-mini-3.8b: d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} x {cfg.head_dim}, vocab {cfg.vocab_size}, "
        f"{cfg.param_count():,} params; cuts: {serve_cuts(cfg)}; remat "
        f"{cfg.remat}; FedGKD {BF16_FL} x {BF16_ROUNDS} rounds")
    step_peak_gate(f"phi4-mini-3.8b d{cfg.n_layers} bf16", cfg, dev)
    out, launches, peak = bf16_fl("bf16", cfg, dev, BF16_FL, BF16_ROUNDS)
    add(launches)
    missing = [k for k in BF16_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the bf16 phi4-mini "
                             f"path: {missing}")
    if not out["history"][-1]["kd"] > 0:
        raise AssertionError("bf16 phi4-mini: the KD term is 0 in round 2")
    if out["dtypes"] != ["torch.bfloat16"]:
        raise AssertionError(f"bf16 phi4-mini: params in {out['dtypes']}")
    del out
    out, launches32, peak32 = bf16_fl("fp32 (for comparison)", fp32_of(cfg),
                                      dev, BF16_FL, BF16_ROUNDS)
    add(launches32)
    del out
    log(f"  phi4-mini depth {cfg.n_layers}: peak {peak:.2f} GiB in bf16, "
        f"{peak32:.2f} GiB in fp32")

    # round 1 of the smoke config, card against the CPU
    add(smoke_round_vs_cpu("phi4-mini-3.8b", dev, BF16_CHECK)[1])

    # phi4-mini unchanged: 32 layers, bf16, inference
    cfg = bf16_config("phi4-mini-3.8b", 32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = card_init(cfg, dev)
    log(f"bf16, phi4-mini-3.8b unchanged: {cfg.n_layers} layers, "
        f"{cfg.param_count():,} params")
    gen = torch.Generator(device=dev).manual_seed(8)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, SERVE_PREFILL,
                                     device=dev, generator=gen)}
    reset_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    last = steps.make_prefill_step(cfg, last_only=True)(params, batch)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    prompts = make_prompts(SERVE_REQ["requests"], cfg.vocab_size,
                           SERVE_REQ["prompt_len"])
    stats = serve_on(cfg, params, prompts, dev)
    add(dict(LAUNCHES))
    log(f"  prefill (last_only) of {SERVE_PREFILL}: {ms:.1f} ms; ServeLoop: "
        f"{SERVE_REQ['requests']} requests, batch {SERVE_REQ['batch']}, "
        f"{SERVE_REQ['gen']} generated: {stats['seconds']:.4f} s, "
        f"{stats['decode_steps']} decode steps, {stats['tok_per_s']:.2f} tok/s")
    if not (tuple(last.shape) == (SERVE_PREFILL[0], 1, cfg.vocab_size)
            and all_finite(last)):
        raise AssertionError("bf16 phi4-mini prefill: wrong shape or "
                             "non-finite")
    del last
    prompt = torch.randint(0, cfg.vocab_size,
                           (SERVE_CHECK_BATCH, SERVE_DECODE_PROMPT),
                           device=dev, generator=gen)
    dec, toks = greedy_decode(cfg, params, prompt, SERVE_DECODE_STEPS, dev)
    with torch.no_grad():
        full, _ = transformer.forward(params, cfg, toks)
        params32 = tree_map(lambda t: t.float(), params)
        full32, _ = transformer.forward(params32, fp32_of(cfg), toks)
    del params32
    worst = bf16_parity("bf16 phi4-mini decode against its forward",
                        [dec], [full], [full32])
    log(f"  greedy decode over {toks.shape[1]} positions (bf16 caches): "
        f"{float((dec - full32).abs().max()):.3e} from the fp32 forward, "
        f"the bf16 forward {float((full - full32).abs().max()):.3e} (max "
        f"|logit| {float(full32.abs().max()):.3e}); {worst:.3f} of the bar; "
        f"peak {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    del params, dec, full, full32
    torch.cuda.empty_cache()
    ccfg = bf16_config("phi4-mini-3.8b", 1)
    cparams = card_init(ccfg, dev, seed=1)
    cstats = serve_on(ccfg, cparams, prompts, dev)
    serve_tokens_vs_cpu("bf16 phi4-mini-3.8b (1 layer)", ccfg, cparams,
                        prompts, cstats, dev)
    del cparams

    # mamba2 in bf16 at the LM phase's depth and run
    mcfg = bf16_config(LM_ARCH, LM_LAYERS)
    log(f"bf16, {LM_ARCH}: {serve_cuts(mcfg)}; FedGKD {LM_RUN}")
    out, launches, peak = bf16_fl(f"bf16 {LM_ARCH}", mcfg, dev, LM_RUN, 1)
    add(launches)
    missing = [k for k in LM_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the bf16 {LM_ARCH} "
                             f"path: {missing}")
    del out
    # its smoke round on the card against the CPU's: gated with one local
    # step a client; a client's second step amplifies the first step's
    # one-ulp differences several times over in either package (ROADMAP
    # C), so the two-step round is read, not gated
    add(smoke_round_vs_cpu(LM_ARCH, dev, BF16_MAMBA_CHECK)[1])
    smoke_round_vs_cpu(LM_ARCH, dev, BF16_CHECK, gate=False)

    # the one-client-per-device round, the card twice over
    cfg = bf16_config("phi4-mini-3.8b", 2)
    with card_weights(dev):
        reset_launches()
        t0 = time.perf_counter()
        sharded = run_sharded(cfg, devices=[dev, dev], verbose=False,
                              **BF16_SHARDED)
        t_sharded = time.perf_counter() - t0
        add(dict(LAUNCHES))
        serial = run_serial(cfg, n_clients=2, device=dev, verbose=False,
                            **BF16_SHARDED)
    diff = params_diff(sharded["params"], serial["params"])
    log(f"  run_sharded on [card, card] (phi4-mini bf16, depth 2, "
        f"{BF16_SHARDED}): {t_sharded:.2f} s, loss "
        f"{sharded['history'][0]['loss']:.6f}, ppl "
        f"{sharded['history'][0]['ppl']:.6g}; against run_serial(n_clients=2)"
        f": max param diff {diff:.3e}, ppl {serial['history'][0]['ppl']:.6g}")
    # the perplexity may be inf: phi4-mini's tied head at full width gives
    # the input token a logit of ~|e|^2 ~ d_model from the init, an eval
    # CE past float64's exp (as in the serve phase's round)
    if not (math.isfinite(sharded["history"][0]["loss"])
            and all_finite(sharded["params"])):
        raise AssertionError("run_sharded on the card: non-finite loss or "
                             "params")
    if not (diff == 0.0 and sharded["history"][0]["ppl"]
            == serial["history"][0]["ppl"]):
        raise AssertionError(f"run_sharded on the card twice over differs "
                             f"from run_serial: {diff}")
    return total


# ---------------------------------------------------------------------------
# the MoE phase: mixtral-8x7b at its published width in bf16
# ---------------------------------------------------------------------------

def deepseek_options(cfg):
    """DeepSeek-V3's MoE options on a GQA config: sigmoid scores
    renormalised over the top-k, one shared expert, one leading dense
    layer and the MTP head (``tests/test_torch_moe.py``'s variant)."""
    return cfg.replace(moe=cfg.moe._replace(router_type="sigmoid",
                                            n_shared_experts=1),
                       first_k_dense=1, mtp_depth=1)


def lossless(cfg):
    """``cfg`` with a capacity of E / top-k: no group can drop a token."""
    return cfg.replace(moe=cfg.moe._replace(
        capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


@contextlib.contextmanager
def moe_reads():
    """Inside the block, each MoE dispatch's dropped (token, choice)
    entries and the number it routed, and each MoE layer's load-balance
    loss, kept on the device (no host sync) and read after the block:
    ``{"dropped": [...], "entries": n, "aux": [...]}``.  Under remat a
    layer's dispatch runs again in the backward, and is counted again."""
    from repro_torch.models import moe

    seen = {"dropped": [], "entries": 0, "aux": []}
    real_plan, real_apply = moe.dispatch_plan, moe.moe_apply

    def plan(top_idx, cap, n_experts):
        slot, keep = real_plan(top_idx, cap, n_experts)
        seen["dropped"].append((~keep).sum())
        seen["entries"] += keep.numel()
        return slot, keep

    def apply(params, x, cfg):
        out, aux = real_apply(params, x, cfg)
        seen["aux"].append(aux.detach())
        return out, aux

    moe.dispatch_plan, moe.moe_apply = plan, apply
    try:
        yield seen
    finally:
        moe.dispatch_plan, moe.moe_apply = real_plan, real_apply


def run_moe(dev) -> dict:
    """mixtral-8x7b in bf16 at published width: ``BF16_ROUNDS`` FedGKD rounds
    at depth 2 (B4's bf16 form, B6, B1 and B2 launched; KD non-zero in
    round 2; the load-balance loss > 0; the share of assignments dropped
    by capacity; peak GiB; a profiled round), depth 8 for a prefill and
    ``ServeLoop``, then, on lossless copies at depth 2, greedy decode
    against the forward in fp32 (the reference's bar) and over bf16
    caches (``bf16_parity``) and the ring gate; round 1 of the smoke config
    and of ``deepseek_options`` on the card against the CPU in fp32
    (``first_round_check``) and bf16 (``smoke_round_vs_cpu``).  Each run
    whose launches count is a main path's, with the counts set to 0 just
    before and read just after.  Returns the launch counts."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.train import run_serial
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    total = dict.fromkeys(LAUNCHES, 0)

    def add(counts):
        for k, n in counts.items():
            total[k] += n

    # training at depth 2
    cfg = bf16_config(MOE_ARCH, MOE_TRAIN_LAYERS)
    m = cfg.moe
    log(f"MoE, {MOE_ARCH}: d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} x {cfg.head_dim}, window {cfg.attn_window}, "
        f"{m.n_experts} experts of d_ff {m.d_ff}, top-{m.top_k} "
        f"({m.router_type}), capacity factor {m.capacity_factor}, group "
        f"{cfg.moe_group_size}, vocab {cfg.vocab_size}, "
        f"{cfg.param_count():,} params ({cfg.active_param_count():,} active "
        f"a token); cuts: {serve_cuts(cfg)}; remat {cfg.remat}; FedGKD "
        f"{BF16_FL} x {BF16_ROUNDS} rounds")
    step_peak_gate(f"{MOE_ARCH} d{cfg.n_layers} bf16", cfg, dev)
    with moe_reads() as seen:
        out, launches, peak = bf16_fl(f"bf16 {MOE_ARCH}", cfg, dev, BF16_FL,
                                      BF16_ROUNDS)
    add(launches)
    dropped = int(sum(int(d) for d in seen["dropped"]))
    aux = torch.stack(seen["aux"]).float().cpu()
    log(f"  {MOE_ARCH}: {dropped} of {seen['entries']} (token, choice) "
        f"entries dropped by capacity ({dropped / seen['entries']:.4f}) over "
        f"{len(seen['dropped'])} dispatches (training, remat, teacher, "
        f"evaluation; the profiled rounds included); load-balance loss "
        f"x coef a layer {float(aux.min()):.6f}-{float(aux.max()):.6f}; "
        f"peak {peak:.2f} GiB (limit {MOE_PEAK_GIB})")
    missing = [k for k in BF16_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {MOE_ARCH} path: "
                             f"{missing}")
    if not out["history"][-1]["kd"] > 0:
        raise AssertionError(f"{MOE_ARCH}: the KD term is 0 in round 2")
    if not (bool(torch.isfinite(aux).all()) and float(aux.min()) > 0):
        raise AssertionError(f"{MOE_ARCH}: load-balance loss not > 0")
    if out["dtypes"] != ["torch.bfloat16", "torch.float32"]:
        raise AssertionError(f"{MOE_ARCH}: params in {out['dtypes']} (bf16, "
                             f"the routers fp32)")
    if not peak < MOE_PEAK_GIB:
        raise AssertionError(f"{MOE_ARCH}: peak {peak:.2f} GiB")
    del out

    # serving at depth 8
    cfg = bf16_config(MOE_ARCH, MOE_SERVE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = card_init(cfg, dev)
    log(f"MoE serve, {MOE_ARCH}: {serve_cuts(cfg)}, {cfg.param_count():,} "
        f"params")
    gen = torch.Generator(device=dev).manual_seed(8)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, SERVE_PREFILL,
                                     device=dev, generator=gen)}
    prompts = make_prompts(SERVE_REQ["requests"], cfg.vocab_size,
                           SERVE_REQ["prompt_len"])
    reset_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    last = steps.make_prefill_step(cfg, last_only=True)(params, batch)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    stats = serve_on(cfg, params, prompts, dev)
    add(dict(LAUNCHES))
    log(f"  prefill (last_only) of {SERVE_PREFILL}: {ms:.1f} ms; ServeLoop: "
        f"{SERVE_REQ['requests']} requests, batch {SERVE_REQ['batch']}, "
        f"{SERVE_REQ['gen']} generated: {stats['seconds']:.4f} s, "
        f"{stats['decode_steps']} decode steps, {stats['tok_per_s']:.2f} "
        f"tok/s; peak {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} "
        f"GiB")
    if not (tuple(last.shape) == (SERVE_PREFILL[0], 1, cfg.vocab_size)
            and all_finite(last)):
        raise AssertionError(f"{MOE_ARCH} prefill: wrong shape or non-finite")
    if len(stats["outputs"]) != SERVE_REQ["requests"]:
        raise AssertionError(f"{MOE_ARCH} ServeLoop: {stats['outputs']}")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = serve_on(cfg, params, prompts, dev)
    device_busy(prof, f"{MOE_ARCH} ServeLoop, a second run",
                again["seconds"] * 1e3, top=6)
    del params, last, prof
    torch.cuda.empty_cache()

    # decode against the forward on lossless copies at depth 2
    cfg = lossless(bf16_config(MOE_ARCH, MOE_DECODE_LAYERS))
    params = card_init(cfg, dev)
    slots = max(1, math.ceil(SERVE_REQ["batch"] * m.top_k / m.n_experts
                             * m.capacity_factor))
    log(f"MoE decode, {MOE_ARCH}: depth {cfg.n_layers}, capacity factor "
        f"{cfg.moe.capacity_factor} (lossless: the published "
        f"{m.capacity_factor} gives a decode step of {SERVE_REQ['batch']} "
        f"tokens {slots} slots an expert, so decode would drop tokens the "
        f"forward keeps)")
    prompt = torch.randint(0, cfg.vocab_size,
                           (SERVE_CHECK_BATCH, SERVE_DECODE_PROMPT),
                           device=dev, generator=gen)
    dec, toks = greedy_decode(cfg, params, prompt, SERVE_DECODE_STEPS, dev)
    params32 = tree_map(lambda t: t.float(), params)
    cfg32 = fp32_of(cfg)
    with torch.no_grad():
        full, _ = transformer.forward(params, cfg, toks)
        full32, _ = transformer.forward(params32, cfg32, toks)
    worst = bf16_parity(f"bf16 {MOE_ARCH} decode against its forward",
                        [dec], [full], [full32])
    log(f"  greedy decode over {toks.shape[1]} positions (bf16 caches): "
        f"{float((dec - full32).abs().max()):.3e} from the fp32 forward, the "
        f"bf16 forward {float((full - full32).abs().max()):.3e} (max |logit| "
        f"{float(full32.abs().max()):.3e}); {worst:.3f} of the bar")
    del params, dec, full, full32
    decode_vs_forward(f"{MOE_ARCH} fp32", cfg32, params32, dev,
                      SERVE_DECODE_PROMPT, SERVE_DECODE_STEPS)
    wcfg = cfg32.replace(attn_window=SERVE_WINDOW)
    wtoks = torch.randint(0, cfg.vocab_size, (1, SERVE_RING_TOKENS),
                          device=dev, generator=gen)
    cache = transformer.init_cache(wcfg, 1, SERVE_RING_TOKENS, torch.float32,
                                   device=dev)
    serve_step = steps.make_serve_step(wcfg)
    outs = []
    for i in range(SERVE_RING_TOKENS):
        lg, cache = serve_step(params32, cache, wtoks[:, i:i + 1])
        outs.append(lg[:, 0])
    with torch.no_grad():
        full, _ = transformer.forward(params32, wcfg, wtoks)
    against_forward(f"{MOE_ARCH} fp32 ring buffer: window {SERVE_WINDOW} (a "
                    f"ring of {cache['seg0'].k.shape[2]} slots) over "
                    f"{SERVE_RING_TOKENS} tokens", torch.stack(outs, 1), full)
    del params32, full, outs, cache
    torch.cuda.empty_cache()

    # round 1 of the smoke configs, card against CPU: fp32, then bf16
    for variant in (None, deepseek_options):
        scfg = fp32_of((variant or (lambda c: c))(get_smoke_config(MOE_ARCH)))
        name = MOE_ARCH if variant is None else f"{MOE_ARCH} ({variant.__name__})"

        def params_after(device, rounds, scfg=scfg):
            out = run_serial(scfg, rounds=rounds, algo="fedgkd",
                             device=device, verbose=False, **MOE_CHECK)
            return [t.detach().cpu().numpy()
                    for t in tree_leaves(out["params"])]

        first_round_check(dev, f"fp32 {name} smoke round ({MOE_CHECK})",
                          MOE_CHECK["lr"], params_after)
        add(smoke_round_vs_cpu(MOE_ARCH, dev, MOE_CHECK, variant=variant)[1])
    log(f"MoE phase: {time.perf_counter() - t_phase:.1f} s; launches "
        f"{ {k: n for k, n in total.items() if n} }")
    return total


# ---------------------------------------------------------------------------
# the last families: MLA (deepseek-v3), the encoder-decoder (seamless-m4t)
# and the frontend prefix (llava-next), at their published widths in bf16
# ---------------------------------------------------------------------------

def check_family_kernels(dev, seen) -> tuple[dict, list]:
    """B4 (both forms), B1, B2 and B6 against their plain versions at every
    shape that the families' phase gave them on the card (``record_shapes``),
    each with its launches there: B4's fp32 form to ``KERNEL_TOL``, its
    bf16 form to one bf16 ulp of the fp32 plain version on the same values
    upcast and to the reference's 2e-2 of the bf16 plain version; B1, B2
    and B6 (fp32 logits) to ``KERNEL_TOL``.  Each B4 shape, and each B1,
    B2, B6 shape of a vocabulary of 10,000 or more, is timed against its
    plain version, its bound and a PyTorch call (sdpa: without a mask for
    the non-causal forms, ``is_causal`` where Sq = Skv, else the boolean
    mask; ``logsumexp``; ``kl_div`` of ``log_softmax``).  Returns (max abs
    error by launch counter, the timed rows)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.kd_kl import ops as kd_ops
    from repro_torch.kernels.kd_kl import ref as kd_ref
    from repro_torch.launch import roofline as rl

    gen = torch.Generator(device=dev).manual_seed(25)
    err, rows = {}, []

    def note(counter, e):
        err[counter] = max(err.get(counter, 0.0), e)

    flash = sorted((k for k in seen if k[0] == "flash_attention_fwd"),
                   key=str)
    for key in flash:
        _, qs, ks, causal, window, dtype = key
        b, sq, hq, d = qs
        skv, hkv = ks[1], ks[2]
        bf16 = dtype == "torch.bfloat16"
        q, k, v = (torch.randn(s_, device=dev, generator=gen)
                   for s_ in (qs, ks, ks))
        if bf16:
            q, k, v = (t.bfloat16() for t in (q, k, v))
        got = fa_ops.flash_attention_fwd(q, k, v, causal, window)
        want = fa_ref.attention_ref(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
        name = f"flash q{qs} kv{ks} causal {causal} window {window} {dtype}"
        if bf16:
            counter = "flash_attention_fwd_bf16"
            e = bf16_compare(name, got, want)
            plain = fa_ref.attention_ref(q, k, v, causal=causal,
                                         window=window).float()
            if not bool(((got.float() - plain).abs()
                         <= BF16_FLASH_TOL * (1 + plain.abs())).all()):
                raise AssertionError(f"{name}: past {BF16_FLASH_TOL} of the "
                                     f"bf16 plain version")
        else:
            counter = "flash_attention_fwd"
            e = compare(name, got, want)
        note(counter, e)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = (fa_ref.causal_mask(sq, skv, window=window, device=dev)
                if causal else None)
        lib_kw = dict(enable_gqa=hkv != hq)
        if causal and sq == skv and window is None:
            lib_kw["is_causal"], lib_form = True, "is_causal"
        elif causal:
            lib_kw["attn_mask"], lib_form = mask, "mask"
        else:
            lib_form = "no mask"

        def library(lib_kw=lib_kw):
            return F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)

        t = dict(ms=time_ms(lambda: fa_ops.flash_attention_fwd(
                     q, k, v, causal, window), reps=5, replays=4),
                 plain_ms=time_ms(lambda: fa_ref.attention_ref(
                     q, k, v, causal=causal, window=window), reps=2,
                     replays=2),
                 library_ms=time_ms(library, reps=5, replays=4))
        t.update((rl.bf16_flash_bound_ms if bf16 else rl.tf32x3_bound_ms)(
            *rl.flash_cost(b, sq, skv, hq, hkv, d, causal, window,
                           elt=2 if bf16 else 4)[:2]))
        row = dict(name=counter, shape=[list(qs), list(ks), causal, window],
                   launches=seen[key], max_abs_err=e, library=lib_form, **t)
        rows.append(row)
        log(f"  {name}: {seen[key]} launches, err {e:.2e}, kernel "
            f"{t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms sdpa "
            f"({lib_form}) {t['library_ms']:.4f} ms bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"{t['bound_ms'] / t['ms']:.3f} of it")
        del q, k, v, qt, kt, vt, got, want
    kd = sorted({k_[1:] for k_ in seen if k_[0] in ("kd_kl_fwd", "kd_kl_bwd")},
                key=str)
    for (rows_n, vocab), temp in kd:
        lt = torch.randn(rows_n, vocab, device=dev, generator=gen) * 2
        ls = torch.randn(rows_n, vocab, device=dev, generator=gen) * 2
        g = torch.randn(rows_n, device=dev, generator=gen)
        kl, lse_t, lse_s = kd_ops.kd_kl_fwd(lt, ls, temp)
        want = kd_ref.kd_kl_fwd_ref(lt, ls, temp)
        note("kd_kl_fwd", max(compare(f"kd_kl_fwd ({rows_n}, {vocab}):{nm}",
                                      a, w)
                              for nm, a, w in zip(("kl", "lse_t", "lse_s"),
                                                  (kl, lse_t, lse_s), want)))
        note("kd_kl_bwd", compare(
            f"kd_kl_bwd ({rows_n}, {vocab})",
            kd_ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, temp),
            kd_ref.kd_kl_bwd_ref(lt, ls, lse_t, lse_s, g, temp)))
        if vocab >= 10_000:
            for name, kern, plain, lib, (bnd, by) in (
                    ("kd_kl_fwd", lambda: kd_ops.kd_kl_fwd(lt, ls, temp),
                     lambda: kd_ref.kd_kl_fwd_ref(lt, ls, temp),
                     lambda: F.kl_div(F.log_softmax(ls, -1),
                                      F.log_softmax(lt, -1), reduction="none",
                                      log_target=True).sum(-1),
                     rl.kd_kl_fwd_cost(rows_n, vocab).bound()),
                    ("kd_kl_bwd",
                     lambda: kd_ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, temp),
                     lambda: kd_ref.kd_kl_bwd_ref(lt, ls, lse_t, lse_s, g,
                                                  temp), None,
                     rl.kd_kl_bwd_cost(rows_n, vocab).bound())):
                t = dict(ms=time_ms(kern, reps=5, replays=4),
                         plain_ms=time_ms(plain, reps=2, replays=2),
                         library_ms=(time_ms(lib, reps=2, replays=2) if lib
                                     else None), bound_ms=bnd, bound_by=by)
                launches = seen[(name, (rows_n, vocab), temp)]
                rows.append(dict(name=name, shape=[rows_n, vocab],
                                 launches=launches, **t))
                lib_s = (f"{t['library_ms']:.4f}" if lib else "none")
                log(f"  {name} ({rows_n}, {vocab}): {launches} launches, "
                    f"kernel {t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms "
                    f"library {lib_s} ms bound {bnd:.4f} ms ({by}), "
                    f"{bnd / t['ms']:.3f} of it")
        del lt, ls, g, kl, lse_t, lse_s, want
    for key in sorted((k_ for k_ in seen if k_[0] == "row_lse_fwd"), key=str):
        _, (rows_n, vocab), temp = key
        ls = torch.randn(rows_n, vocab, device=dev, generator=gen) * 2
        e = compare(f"row_logsumexp ({rows_n}, {vocab})",
                    kd_ops.row_lse_fwd(ls, temp),
                    kd_ref.row_logsumexp_ref(ls, temp))
        note("row_logsumexp", e)
        if vocab >= 10_000:
            bnd, by = rl.row_lse_cost(rows_n, vocab).bound()
            t = dict(ms=time_ms(lambda: kd_ops.row_lse_fwd(ls, temp), reps=5,
                                replays=4),
                     plain_ms=time_ms(lambda: kd_ref.row_logsumexp_ref(
                         ls, temp), reps=2, replays=2),
                     library_ms=time_ms(lambda: torch.logsumexp(ls / temp, -1),
                                        reps=2, replays=2),
                     bound_ms=bnd, bound_by=by)
            rows.append(dict(name="row_logsumexp", shape=[rows_n, vocab],
                             launches=seen[key], max_abs_err=e, **t))
            log(f"  row_logsumexp ({rows_n}, {vocab}): {seen[key]} launches, "
                f"err {e:.2e}, kernel {t['ms']:.4f} ms plain "
                f"{t['plain_ms']:.4f} ms logsumexp {t['library_ms']:.4f} ms "
                f"bound {bnd:.4f} ms ({by}), {bnd / t['ms']:.3f} of it")
        del ls
    log(f"  families' kernel shapes: B4 at {len(flash)}, B1/B2 at {len(kd)}, "
        f"B6 at {sum(1 for k_ in seen if k_[0] == 'row_lse_fwd')}; max abs "
        f"err {err}")
    return err, rows


def fp32_in_place(tree: dict) -> dict:
    """A params dict's leaves cast to fp32 one at a time, each old leaf
    freed (and the allocator's cache emptied) before the next: a 14B-
    parameter tree in bf16 and in fp32 at once does not fit the card."""
    import torch

    for key in list(tree):
        if isinstance(tree[key], dict):
            fp32_in_place(tree[key])
        else:
            tree[key] = tree[key].float()
            torch.cuda.empty_cache()
    return tree


def step_rounds(label, cfg, params, batches, rounds: int, dev,
                round_callback=None) -> tuple:
    """FedGKD rounds driven through ``launch.steps``: each client (a list of
    batches in ``batches``) runs ``make_train_step(kd_mode="teacher")``
    from the global params with a fresh SGD momentum, the teacher the
    previous round's global (round 1's the initial params), and the
    clients are averaged by ``make_aggregate_step`` with equal weights.
    Returns (the final params, [{round, seconds, loss, kd}]), each round's
    seconds between two synchronisations of ``dev``;
    ``round_callback(round)`` is called after each round's
    synchronisation (``profile_round``'s window)."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.optim import sgd

    opt = sgd(momentum=0.9)
    step = steps.make_train_step(cfg, opt, kd_mode="teacher",
                                 gamma=FAM_FL["gamma"], lr=FAM_FL["lr"])
    aggregate = steps.make_aggregate_step()
    teacher, history = params, []
    for rnd in range(1, rounds + 1):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        clients, last = [], []
        for client in batches:
            p, state = params, opt.init(params)
            for batch in client:
                p, state, m = step(p, teacher, state, batch)
            clients.append(p)
            last.append(m)
        teacher, params = params, aggregate(clients, [1.0] * len(clients))
        del clients, p, state
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        if round_callback is not None:
            round_callback(rnd)
        rec = dict(round=rnd, seconds=seconds,
                   loss=sum(float(m["loss"]) for m in last) / len(last),
                   kd=sum(float(m["kd"]) for m in last) / len(last))
        history.append(rec)
        if label:
            log(f"  {label} round {rnd}: {rec['seconds']:.3f} s loss "
                f"{rec['loss']:.6f} kd {rec['kd']:.6e}")
    return params, history


def family_batches(cfg, dev, n_clients: int, n_batches: int, batch: int,
                   seq: int, frames: int, seed: int) -> list:
    """Client batches for ``step_rounds``: ``seq`` + 1 random tokens a row
    (tokens and labels of ``seq`` positions) and, for an encoder-decoder
    or a frontend model, ``frames`` synthetic frontend embeddings a row
    (``models.frontends.synth_embeddings``), drawn on ``dev`` from the
    seed."""
    import torch

    from repro_torch.models import frontends

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(n_clients):
        client = []
        for _ in range(n_batches):
            toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                                 device=dev, generator=gen)
            b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            if cfg.enc_layers or cfg.frontend:
                key = ("enc_embeddings" if cfg.enc_layers
                       else "frontend_embeddings")
                b[key] = frontends.synth_embeddings(gen, batch, frames,
                                                    cfg.d_model, cfg.adtype)
            client.append(b)
        out.append(client)
    return out


def smoke_steps_vs_cpu(arch: str, dev) -> None:
    """Round 1 of ``step_rounds`` on ``arch``'s smoke config in fp32 (2
    clients x 2 batches of 2 x 32 positions, 16 frontend positions), card
    against CPU from the same init (``first_round_check``)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves, tree_map

    scfg = get_smoke_config(arch)
    init = transformer.init(torch.Generator().manual_seed(0), scfg)
    batches = family_batches(scfg, torch.device("cpu"), 2, 2, 2, 32,
                             scfg.frontend_seq, seed=5)

    def params_after(device, rounds):
        device = torch.device(device)
        to = lambda t: t.to(device)                      # noqa: E731
        p, _ = step_rounds("", scfg, tree_map(to, init),
                           [[{k: to(v) for k, v in b.items()} for b in c]
                            for c in batches], rounds, device)
        return [t.detach().cpu().numpy() for t in tree_leaves(p)]

    first_round_check(dev, f"fp32 {arch} smoke round through the steps (2 "
                      f"clients x 2 batches of 2 x 32)", FAM_FL["lr"],
                      params_after)


def run_families(dev) -> tuple[dict, dict]:
    """The last model families at published widths in bf16
    (``family_runs``), with the shapes of B4, B1, B2 and B6 counted, then
    each kernel held to its plain version at every one of them and timed
    (``check_family_kernels``).  Returns (launch counts, max abs errors)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with record_shapes() as seen:
        launches = family_runs(dev)
    torch.cuda.empty_cache()
    err, rows = check_family_kernels(dev, seen)
    log(f"families kernel rows (JSON): {json.dumps(rows)}")
    log(f"families phase: {time.perf_counter() - t0:.1f} s; launches "
        f"{ {k: n for k, n in launches.items() if n} }; max abs err {err}")
    return launches, err


def timed_prefill(cfg, params, batch, dev) -> tuple:
    """``make_prefill_step(last_only=True)`` twice on the card, each call
    between two synchronisations: (the logits, "first / second" ms; the
    first call also pays for its shapes' first use)."""
    import torch

    from repro_torch.launch import steps

    prefill = steps.make_prefill_step(cfg, last_only=True)
    times = []
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        last = prefill(params, batch)
        torch.cuda.synchronize(dev)
        times.append(f"{(time.perf_counter() - t0) * 1e3:.1f}")
    return last, " / ".join(times)


def family_runs(dev) -> dict:
    """deepseek-v3 (MLA, the MoE run, MTP), seamless-m4t (the
    encoder-decoder at full depth) and llava-next (the frontend prefix),
    each run whose launches count as a main path's with the counts set to 0
    just before and read just after.  Returns the summed launch counts."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.train import run_serial
    from repro_torch.models import frontends, transformer
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_leaves, tree_map

    total = dict.fromkeys(LAUNCHES, 0)

    def add(counts):
        for k, n in counts.items():
            total[k] += n

    def gate(label, counts, kernels):
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {label} path: "
                                 f"{missing}")

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2 ** 30

    def fresh():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- deepseek-v3: training at depth 1 (one dense MLA layer, the MoE
    # run empty, MTP), serving at depth 4 (3 dense + 1 MoE)
    cfg = bf16_config(DS_ARCH, DS_TRAIN_LAYERS).replace(
        first_k_dense=DS_TRAIN_LAYERS)
    m, mla = cfg.moe, cfg.mla
    log(f"families, {DS_ARCH}: d_model {cfg.d_model}, MLA {cfg.n_heads} "
        f"heads (q rank {mla.q_lora_rank}, kv rank {mla.kv_lora_rank}, nope "
        f"{mla.qk_nope_dim} + rope {mla.qk_rope_dim}, v {mla.v_head_dim}), "
        f"dense d_ff {cfg.d_ff}, {m.n_experts} experts of d_ff {m.d_ff} "
        f"top-{m.top_k} ({m.router_type}) + {m.n_shared_experts} shared, "
        f"MTP {cfg.mtp_depth}, vocab {cfg.vocab_size}; training: "
        f"{cfg.segments()}, {cfg.param_count():,} params; cuts: "
        f"{serve_cuts(cfg)}, first_k_dense 3 -> {cfg.first_k_dense} (a MoE "
        f"layer alone holds {m.n_experts * 3 * cfg.d_model * m.d_ff:,}); "
        f"FedGKD {BF16_FL} x {BF16_ROUNDS} rounds")
    step_peak_gate(f"{DS_ARCH} d{cfg.n_layers} bf16", cfg, dev)
    out, launches, peak = bf16_fl(f"bf16 {DS_ARCH}", cfg, dev, BF16_FL,
                                  BF16_ROUNDS)
    add(launches)
    gate(DS_ARCH, launches, DS_KERNELS)
    if not out["history"][-1]["kd"] > 0:
        raise AssertionError(f"{DS_ARCH}: the KD term is 0 in round 2")
    if out["dtypes"] != ["torch.bfloat16", "torch.float32"]:
        raise AssertionError(f"{DS_ARCH}: params in {out['dtypes']}")
    if not peak < FAM_PEAK_GIB:
        raise AssertionError(f"{DS_ARCH}: peak {peak:.2f} GiB")
    log(f"  {DS_ARCH} depth {cfg.n_layers}: peak {peak:.2f} GiB (limit "
        f"{FAM_PEAK_GIB})")
    del out

    cfg = bf16_config(DS_ARCH, DS_SERVE_LAYERS)
    fresh()
    params = card_init(cfg, dev)
    log(f"families serve, {DS_ARCH}: {cfg.segments()}, {serve_cuts(cfg)}, "
        f"{cfg.param_count():,} params")
    gen = torch.Generator(device=dev).manual_seed(8)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, SERVE_PREFILL,
                                     device=dev, generator=gen)}
    prompts = make_prompts(SERVE_REQ["requests"], cfg.vocab_size,
                           SERVE_REQ["prompt_len"])
    reset_launches()
    last, ms = timed_prefill(cfg, params, batch, dev)
    stats = serve_on(cfg, params, prompts, dev)
    add(dict(LAUNCHES))
    one = transformer.init_cache(cfg, 1, 1)["seg0"]
    per_token = sum(t.numel() * t.element_size() for t in one[:2]) // \
        one.c_kv.shape[0]
    gqa = 2 * cfg.n_heads * cfg.mla.v_head_dim * one.c_kv.element_size()
    log(f"  prefill (last_only) of {SERVE_PREFILL}: {ms} ms; ServeLoop: "
        f"{SERVE_REQ['requests']} requests, batch {SERVE_REQ['batch']}, "
        f"{SERVE_REQ['gen']} generated: {stats['seconds']:.4f} s, "
        f"{stats['decode_steps']} decode steps, {stats['tok_per_s']:.2f} "
        f"tok/s; peak {peak_gib():.2f} GiB; the MLA cache {per_token} bytes "
        f"a token a layer in bf16 ({cfg.mla.kv_lora_rank} + "
        f"{cfg.mla.qk_rope_dim} values), where {cfg.n_heads} heads of "
        f"{cfg.mla.v_head_dim} keys and values would take {gqa}")
    if not (tuple(last.shape) == (SERVE_PREFILL[0], 1, cfg.vocab_size)
            and all_finite(last)):
        raise AssertionError(f"{DS_ARCH} prefill: wrong shape or non-finite")
    if len(stats["outputs"]) != SERVE_REQ["requests"]:
        raise AssertionError(f"{DS_ARCH} ServeLoop: {stats['outputs']}")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = serve_on(cfg, params, prompts, dev)
    device_busy(prof, f"{DS_ARCH} ServeLoop, a second run",
                again["seconds"] * 1e3, top=6)
    del params, last, prof

    # decode against the forward: a lossless copy at depth 2 (one dense
    # MLA layer and one MoE layer), no MTP head (decode never reads it)
    cfg = lossless(bf16_config(DS_ARCH, 2).replace(first_k_dense=1,
                                                   mtp_depth=0))
    fresh()
    params = card_init(cfg, dev)
    prompt = torch.randint(0, cfg.vocab_size,
                           (SERVE_CHECK_BATCH, SERVE_DECODE_PROMPT),
                           device=dev, generator=gen)
    dec, toks = greedy_decode(cfg, params, prompt, SERVE_DECODE_STEPS, dev)
    with torch.no_grad():
        full, _ = transformer.forward(params, cfg, toks)
    cfg32 = fp32_of(cfg)
    params32 = fp32_in_place(params)
    with torch.no_grad():
        full32, _ = transformer.forward(params32, cfg32, toks)
    worst = bf16_parity(f"bf16 {DS_ARCH} decode against its forward", [dec],
                        [full], [full32])
    log(f"  {DS_ARCH} decode check: {cfg.segments()}, capacity factor "
        f"{cfg.moe.capacity_factor} (lossless), {cfg.param_count():,} "
        f"params; greedy decode over {toks.shape[1]} positions (bf16 MLA "
        f"caches): {float((dec - full32).abs().max()):.3e} from the fp32 "
        f"forward, the bf16 forward {float((full - full32).abs().max()):.3e} "
        f"(max |logit| {float(full32.abs().max()):.3e}); {worst:.3f} of the "
        f"bar")
    del dec, full, full32
    decode_vs_forward(f"{DS_ARCH} fp32", cfg32, params32, dev,
                      SERVE_DECODE_PROMPT, SERVE_DECODE_STEPS)
    log(f"  peak {peak_gib():.2f} GiB")
    del params, params32

    # round 1 of the smoke config on the card against the CPU's
    scfg = fp32_of(get_smoke_config(DS_ARCH))

    def params_after(device, rounds):
        out = run_serial(scfg, rounds=rounds, algo="fedgkd", device=device,
                         verbose=False, **MOE_CHECK)
        return [t.detach().cpu().numpy() for t in tree_leaves(out["params"])]

    first_round_check(dev, f"fp32 {DS_ARCH} smoke round ({MOE_CHECK})",
                      MOE_CHECK["lr"], params_after)
    add(smoke_round_vs_cpu(DS_ARCH, dev, MOE_CHECK)[1])

    # ---- seamless-m4t at full width and depth: two FedGKD rounds through
    # the steps, a prefill, decode with the encoder's output
    cfg = bf16_config(SEAMLESS_ARCH, get_config(SEAMLESS_ARCH).n_layers)
    fresh()
    params = card_init(cfg, dev)
    log(f"families, {SEAMLESS_ARCH}: {cfg.enc_layers} encoder + "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size} (tied), {cfg.param_count():,} params, "
        f"{cfg.param_dtype}, no cut; {FAM_FL['clients']} clients x "
        f"{FAM_FL['batches']} batches of {FAM_FL['batch']} x "
        f"{FAM_FL['seq']} tokens after "
        f"{frontends.AUDIO_FRAMES} frames, {BF16_ROUNDS} rounds")
    batches = family_batches(cfg, dev, FAM_FL["clients"], FAM_FL["batches"],
                             FAM_FL["batch"], FAM_FL["seq"],
                             frontends.AUDIO_FRAMES, seed=9)
    reset_launches()
    trained, hist = step_rounds(f"bf16 {SEAMLESS_ARCH}", cfg, params, batches,
                                BF16_ROUNDS, dev)
    launches = dict(LAUNCHES)
    add(launches)
    log(f"  {SEAMLESS_ARCH}: peak {peak_gib():.2f} GiB, launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    gate(SEAMLESS_ARCH, launches, FAM_KERNELS)
    if not (hist[-1]["kd"] > 0 and all(math.isfinite(r["loss"])
                                       for r in hist)
            and all_finite(trained)):
        raise AssertionError(f"{SEAMLESS_ARCH}: KD 0 in round 2 or "
                             f"non-finite: {hist}")
    del trained
    profile_round(dev, f"bf16 {SEAMLESS_ARCH}", lambda cb: step_rounds(
        "", cfg, params, batches, 2, dev, round_callback=cb))
    del batches
    pbatch = {"tokens": torch.randint(0, cfg.vocab_size, SERVE_PREFILL,
                                      device=dev, generator=gen),
              "enc_embeddings": frontends.synth_embeddings(
                  gen, SERVE_PREFILL[0], frontends.AUDIO_FRAMES, cfg.d_model,
                  cfg.adtype)}
    reset_launches()
    last, ms = timed_prefill(cfg, params, pbatch, dev)
    frames = frontends.synth_embeddings(gen, SERVE_CHECK_BATCH,
                                        frontends.AUDIO_FRAMES, cfg.d_model,
                                        cfg.adtype)
    with torch.no_grad():
        enc = transformer.encode(params, cfg, frames)
    prompt = torch.randint(0, cfg.vocab_size,
                           (SERVE_CHECK_BATCH, SERVE_DECODE_PROMPT),
                           device=dev, generator=gen)
    dec, toks = greedy_decode(cfg, params, prompt, SERVE_DECODE_STEPS, dev,
                              enc)
    launches = dict(LAUNCHES)
    add(launches)
    gate(f"{SEAMLESS_ARCH} prefill and decode", launches,
         ["flash_attention_fwd_bf16"])
    log(f"  prefill (last_only) of {SERVE_PREFILL} tokens after "
        f"{frontends.AUDIO_FRAMES} frames: {ms} ms")
    if not (tuple(last.shape) == (SERVE_PREFILL[0], 1, cfg.vocab_size)
            and all_finite(last)):
        raise AssertionError(f"{SEAMLESS_ARCH} prefill: wrong shape or "
                             f"non-finite")
    cfg32 = fp32_of(cfg)
    params32 = tree_map(lambda t: t.float(), params)
    with torch.no_grad():
        full, _ = transformer.forward(params, cfg, toks, enc_out=enc)
        enc32 = transformer.encode(params32, cfg32, frames.float())
        full32, _ = transformer.forward(params32, cfg32, toks, enc_out=enc32)
    worst = bf16_parity(f"bf16 {SEAMLESS_ARCH} decode against its forward",
                        [dec], [full], [full32])
    log(f"  greedy decode with the encoder's output over {toks.shape[1]} "
        f"positions (bf16 caches): {float((dec - full32).abs().max()):.3e} "
        f"from the fp32 forward, the bf16 forward "
        f"{float((full - full32).abs().max()):.3e} (max |logit| "
        f"{float(full32.abs().max()):.3e}); {worst:.3f} of the bar")
    del params, dec, full, full32, last
    decode_vs_forward(f"{SEAMLESS_ARCH} fp32", cfg32, params32, dev,
                      SERVE_DECODE_PROMPT, SERVE_DECODE_STEPS, enc32)
    del params32, enc, enc32
    smoke_steps_vs_cpu(SEAMLESS_ARCH, dev)

    # ---- llava-next: depth 2 through two FedGKD rounds of the steps, a
    # cached_topk step, depth 8 for a prefill
    cfg = bf16_config(LLAVA_ARCH, LLAVA_TRAIN_LAYERS)
    fresh()
    params = card_init(cfg, dev)
    patches = steps.text_offset(cfg)            # the prefix: 576 patches
    text = FAM_FL["seq"] - patches
    log(f"families, {LLAVA_ARCH}: d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim} (a group of "
        f"{cfg.n_heads // cfg.n_kv_heads}), theta {cfg.rope_theta:g}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; {cfg.param_count():,} params; "
        f"cuts: {serve_cuts(cfg)}; {FAM_FL['clients']} clients x "
        f"{FAM_FL['batches']} batches of {FAM_FL['batch']} x "
        f"({patches} patches + {text} tokens), {BF16_ROUNDS} "
        f"rounds")
    batches = family_batches(cfg, dev, FAM_FL["clients"], FAM_FL["batches"],
                             FAM_FL["batch"], text, patches,
                             seed=10)
    reset_launches()
    trained, hist = step_rounds(f"bf16 {LLAVA_ARCH}", cfg, params, batches,
                                BF16_ROUNDS, dev)
    launches = dict(LAUNCHES)
    add(launches)
    log(f"  {LLAVA_ARCH}: peak {peak_gib():.2f} GiB, launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    gate(LLAVA_ARCH, launches, FAM_KERNELS)
    if not (hist[-1]["kd"] > 0 and all(math.isfinite(r["loss"])
                                       for r in hist)
            and all_finite(trained)):
        raise AssertionError(f"{LLAVA_ARCH}: KD 0 in round 2 or non-finite: "
                             f"{hist}")
    b = batches[0][0]
    with torch.no_grad():
        t_logits, _ = transformer.forward(
            params, cfg, b["tokens"],
            prefix_embeddings=b["frontend_embeddings"])
        vals, idx = torch.topk(t_logits[:, patches:], FAM_TOPK)
    del t_logits
    opt = sgd(momentum=0.9)
    topk_step = steps.make_train_step(cfg, opt, kd_mode="cached_topk",
                                      gamma=FAM_FL["gamma"], lr=FAM_FL["lr"])
    reset_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, _, mk = topk_step(trained, (), opt.init(trained),
                         {**b, "teacher_topk_vals": vals,
                          "teacher_topk_idx": idx})
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    add(dict(LAUNCHES))
    log(f"  cached_topk step (K = {FAM_TOPK} from torch.topk of the "
        f"teacher's logits at the {text} text positions): {ms:.1f} ms, loss "
        f"{float(mk['loss']):.6f} ce {float(mk['ce']):.6f} kd "
        f"{float(mk['kd']):.6e}")
    if not (math.isfinite(float(mk["loss"])) and float(mk["kd"]) > 0):
        raise AssertionError(f"{LLAVA_ARCH} cached_topk: {mk}")
    del params, trained, batches, b, vals, idx, mk
    cfg = bf16_config(LLAVA_ARCH, LLAVA_SERVE_LAYERS)
    fresh()
    params = card_init(cfg, dev)
    pbatch = {"tokens": torch.randint(
                  0, cfg.vocab_size,
                  (SERVE_PREFILL[0], SERVE_PREFILL[1] - patches),
                  device=dev, generator=gen),
              "frontend_embeddings": frontends.synth_embeddings(
                  gen, SERVE_PREFILL[0], patches, cfg.d_model,
                  cfg.adtype)}
    reset_launches()
    last, ms = timed_prefill(cfg, params, pbatch, dev)
    add(dict(LAUNCHES))
    log(f"  {LLAVA_ARCH} {serve_cuts(cfg)} ({cfg.param_count():,} params): "
        f"prefill (last_only) of {SERVE_PREFILL[0]} x "
        f"({patches} patches + "
        f"{SERVE_PREFILL[1] - patches} tokens): {ms} ms; "
        f"peak {peak_gib():.2f} GiB")
    if not (tuple(last.shape) == (SERVE_PREFILL[0], 1, cfg.vocab_size)
            and all_finite(last)):
        raise AssertionError(f"{LLAVA_ARCH} prefill: wrong shape or "
                             f"non-finite")
    del params, last
    torch.cuda.empty_cache()
    smoke_steps_vs_cpu(LLAVA_ARCH, dev)
    return total


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

    # before anything raises this process's peak RSS, which a child inherits
    footprint = population_footprint()
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
                                   check_conv_dw(dev),
                                   check_flash(dev, text_chunks),
                                   check_ssd(dev, LM_CHECK["seq"] - 1),
                                   check_row_lse(dev)])
    check_vmap_rules(dev)
    launches = [
        run_path(dev, "ResNet-8", *resnet,
                 ["kd_kl_fwd", "kd_kl_bwd", "grouped_conv_fwd",
                  "grouped_conv_dw"]),
        run_path(dev, "AG News text", *text,
                 ["flash_attention_fwd", "kd_kl_fwd", "kd_kl_bwd"],
                 check_lr=TEXT_CHECK_LR),
        run_lm_path(dev),
        run_baselines(dev),
        run_resnet50(dev, *r50),
        run_vmap_body(dev)]
    path_errs = []
    for phase in (run_serve, run_resilience,
                  lambda d: run_population(d, footprint), run_multihost):
        counts, errs = phase(dev)
        launches.append(counts)
        path_errs.append(errs)
    counts, bf16_entries = run_bf16(dev)
    launches.append(counts)
    kernels += bf16_entries
    launches.append(run_moe(dev))
    counts, errs = run_families(dev)
    launches.append(counts)
    path_errs.append(errs)
    for k in kernels:
        k["launches"] = sum(counts[k["name"]] for counts in launches)
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            errs.get(k["name"], 0.0) for errs in path_errs])
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build "
        f"included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == [FOOTPRINT_FLAG]:
        sys.exit(footprint_main())
    if sys.argv[1:2] == [MULTIHOST_FLAG]:
        sys.exit(multihost_child(sys.argv[2:]))
    sys.exit(main())
