#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: kernels and main path.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
``nvcc`` and PyTorch built for CUDA.  It imports the port (``src/repro_torch``)
and nothing of JAX or of the JAX package, and

  1. prints the card's name and power limit (``nvidia-smi``);
  2. builds the port's CUDA kernels from ``src/repro_torch/csrc`` and prints
     the build's seconds and the compiler's register report;
  3. holds every kernel against its plain PyTorch version on the card at
     the main path's shapes — KD-KL forward and backward at (256, 10),
     (256, 100), (256, 200) and a ragged (1000, 37); the client-batched conv
     at all 9 ResNet-8 layers at K=4, N=64, at K=1, N=256 and at K=1 with
     the teacher precompute's chunk sizes (1024 rows and the ragged rest)
     — to 1e-5 of the plain version's largest magnitude (fp32, TF32 off),
     and times the kernel, the plain version and, where one exists, one
     library call (cuDNN's grouped ``conv2d``; ``kl_div`` of
     ``log_softmax``) on the device: CUDA-graph replays between CUDA
     events, so the host's enqueue cost is left out;
  4. drives the main path, ``run_federated`` with FedGKD on ResNet-8 at full
     width (16; 32x32x3 inputs, batch 64, 20 clients at C=0.2 so K=4, 10
     classes), with only depth cut (train size, one local epoch, 5 batches
     per client, 3 rounds), with every launch count set to 0 just before
     and read just after; then one FedAvg round;
  5. profiles one steady-state FedGKD round (``torch.profiler``): host wall
     time, the device's busy time and idle share, device time by kernel;
  6. re-runs FedGKD's first round on the CPU from the same init and holds
     the card's parameters after that round to 1e-4 of the CPU's.

It exits non-zero on any failure.  The last lines of its output are the
kernels' JSON record, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s outside the
# tensor cores.  The kernels here are fp32 on the CUDA cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
KERNEL_TOL = 1e-5          # of max |plain|, fp32 with TF32 off
ROUND_TOL = 1e-4           # card vs CPU params after one round, fp32
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
KD_SHAPES = [(256, 10), (256, 100), (256, 200), (1000, 37)]


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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want) -> float:
    """Max |got - want|; raises if it exceeds KERNEL_TOL·max|want|."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not math.isfinite(err) or err > KERNEL_TOL * max(scale, 1e-30):
        raise AssertionError(f"{name}: max abs err {err:.3e} exceeds "
                             f"{KERNEL_TOL} x max|plain| = {scale:.3e}")
    return err


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
            f"kernel {fwd['ms']:.4f} ms plain {fwd['plain_ms']:.4f} ms "
            f"library {fwd['library_ms']:.4f} ms | bwd err {err_b:.2e} "
            f"kernel {bwd['ms']:.4f} ms plain {bwd['plain_ms']:.4f} ms")
        if (rows, vocab) == (256, 10):          # the CIFAR-10 main path
            rec["kd_kl_fwd"].update(fwd)
            rec["kd_kl_bwd"].update(bwd)
    return [
        dict(name="kd_kl_fwd", route="cuda", source="src/repro_torch/csrc/kd_kl.cu",
             replaces="src/repro/kernels/kd_kl/kernel.py:33", **rec["kd_kl_fwd"]),
        dict(name="kd_kl_bwd", route="cuda", source="src/repro_torch/csrc/kd_kl.cu",
             replaces="src/repro/kernels/kd_kl/kernel.py:113", **rec["kd_kl_bwd"]),
    ]


def check_conv(dev, teacher_ns: list[int]) -> dict:
    """The conv at every ResNet-8 layer: K=4, N=64 (a local step), K=1,
    N=256 (an evaluation batch) and K=1 at ``teacher_ns`` (the teacher
    precompute's chunks)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.grouped_conv import ops, ref

    gen = torch.Generator(device=dev).manual_seed(1)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  nbytes=0.0, ops=0.0)
    max_err = 0.0
    for k, n in [(4, 64), (1, 256)] + [(1, n) for n in teacher_ns]:
        for name, h, cin, cout, kk, s in RESNET8_CONVS:
            x = torch.randn(k, n, h, h, cin, device=dev, generator=gen)
            w = torch.randn(k, kk, kk, cin, cout, device=dev,
                            generator=gen) / math.sqrt(kk * kk * cin)
            oh, lo, hi = ref.same_pads(h, kk, s)
            err = compare(f"grouped_conv K={k} {name}",
                          ops.grouped_conv_fwd(x, w, s, "SAME"),
                          ref.grouped_conv_ref(x, w, s, "SAME"))
            max_err = max(max_err, err)
            # the library yardstick: cuDNN's grouped conv2d on the inputs
            # packed channel-wise (client k's channels are group k) and
            # padded as JAX pads SAME; the packing is not timed
            xg = F.pad(x.permute(1, 0, 4, 2, 3).reshape(n, k * cin, h, h),
                       (lo, hi, lo, hi))
            wg = w.permute(0, 4, 3, 1, 2).reshape(k * cout, cin, kk, kk)
            lib = F.conv2d(xg, wg, stride=s, groups=k)
            compare(f"library conv2d K={k} {name}",
                    lib.reshape(n, k, cout, oh, oh).permute(1, 0, 3, 4, 2),
                    ref.grouped_conv_ref(x, w, s, "SAME"))
            t = dict(ms=time_ms(lambda: ops.grouped_conv_fwd(x, w, s, "SAME")),
                     plain_ms=time_ms(lambda: ref.grouped_conv_ref(x, w, s, "SAME")),
                     library_ms=time_ms(lambda: F.conv2d(xg, wg, stride=s,
                                                         groups=k)))
            nbytes = 4 * (x.numel() + w.numel() + k * n * oh * oh * cout)
            # multiply-adds of the taps inside the input only
            flops = (2 * k * n * cout * cin
                     * taps_in_bounds(h, kk, s, oh, lo) ** 2)
            b, by = bound_ms(nbytes, flops)
            log(f"  conv K={k} N={n:3d} {name:13s} err {err:.2e} kernel "
                f"{t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms library "
                f"{t['library_ms']:.4f} ms bound {b:.4f} ms ({by})")
            if k == 4:                         # one local step's forward
                for key in ("ms", "plain_ms", "library_ms"):
                    totals[key] += t[key]
                totals["nbytes"] += nbytes
                totals["ops"] += flops
    b, by = bound_ms(totals["nbytes"], totals["ops"])
    return dict(name="grouped_conv_fwd", route="cuda",
                source="src/repro_torch/csrc/grouped_conv.cu",
                replaces="src/repro/kernels/grouped_conv/kernel.py:36",
                max_abs_err=max_err, ms=totals["ms"],
                plain_ms=totals["plain_ms"], library_ms=totals["library_ms"],
                bound_ms=b, bound_by=by)


def all_finite(tree) -> bool:
    import torch

    from repro_torch.tree import tree_leaves

    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree))


def profile_round(dev, task, data, kw, make_algo) -> None:
    """Where a steady-state FedGKD round's time goes: round 2 of a 2-round
    run under ``torch.profiler``, its host wall time, the device's busy
    time (the union of its kernels' and copies' intervals), and the device
    time by kernel name.  Prints "not measured" where the profiler saw no
    device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import fl_loop

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wall = {}

    def window(rnd, server, model):    # called after the round's synchronize
        if rnd == 1:
            prof.start()
            wall["t0"] = time.perf_counter()
        elif rnd == 2:
            torch.cuda.synchronize(dev)
            wall["ms"] = (time.perf_counter() - wall["t0"]) * 1e3
            prof.stop()

    fl_loop.run_federated(task, make_algo(), data, device=dev, rounds=2,
                          round_callback=window, **kw)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        log(f"profile (FedGKD round 2): wall {wall['ms']:.3f} ms; device "
            f"busy time not measured (the profiler saw no device activity)")
        return
    busy_us, end, by_name = 0.0, -math.inf, {}
    for lo, hi, name in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + hi - lo, n + 1)
    log(f"profile (FedGKD round 2): wall {wall['ms']:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / 1e3 / wall['ms']:.4f}, "
        f"{len(spans)} device ops")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {t / 1e3:8.3f} ms {n:5d}x  {name[:90]}")


def main_path_setup():
    """The main path's task, data and ``run_federated`` arguments: full
    width; depth cut to 4,500 examples, 1 local epoch, 5 batches per
    client, 3 rounds (the paper: 45,000, 20 epochs, 100 rounds)."""
    from repro_torch.configs.paper import CIFAR10, scaled
    from repro_torch.core import fl_loop

    task = scaled(CIFAR10, 0.1, rounds=3, local_epochs=1)
    data = fl_loop.make_federated_data(task, alpha=0.5, seed=0)
    return task, data, dict(seed=0, max_batches_per_client=5, width=16)


def teacher_chunks(task, data, seed: int) -> list[int]:
    """The row counts of round 1's teacher-precompute conv calls: the
    cohort's K·N_max rows in chunks of ``PRECOMPUTE_CHUNK`` (the full
    chunk and the ragged remainder), from the cohort that ``seed`` draws."""
    import numpy as np

    from repro_torch.core.executor import PRECOMPUTE_CHUNK

    k = max(1, int(round(task.participation * data.n_clients)))
    cohort = data.sample_cohort(np.random.default_rng(seed), k)
    rows = k * max(data.clients[int(c)].n for c in cohort)
    return sorted({min(PRECOMPUTE_CHUNK, rows), rows % PRECOMPUTE_CHUNK} - {0},
                  reverse=True)


def run_main_path(dev, task, data, kw) -> tuple[dict, object]:
    from repro_torch.bridge import params_to_numpy
    from repro_torch.core import algorithms, fl_loop
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.tree import tree_leaves

    first_round = {}

    def keep_first(rnd, server, model):
        if rnd == 1:
            first_round["params"] = params_to_numpy(server["global"])

    def fedgkd():
        return algorithms.make("fedgkd", gamma=task.gamma,
                               buffer_m=task.buffer_m)

    reset_launches()
    t0 = time.perf_counter()
    hist = fl_loop.run_federated(task, fedgkd(), data, device=dev,
                                 round_callback=keep_first, **kw)
    launches = dict(LAUNCHES)
    log(f"main path: FedGKD ResNet-8 width 16, K=4, B=64, "
        f"{time.perf_counter() - t0:.2f} s, launches {launches}")
    for r in hist.records:
        log(f"  round {r.round}: {r.seconds:.3f} s test_acc {r.test_acc:.4f} "
            f"test_loss {r.test_loss:.4f} local_loss {r.mean_local_loss:.4f} "
            f"cohort {list(r.sampled)}")
    losses = [v for r in hist.records for v in (r.test_loss, r.mean_local_loss)]
    if not (all(map(math.isfinite, losses)) and all_finite(hist.final_params)):
        raise AssertionError(f"FedGKD: non-finite loss or params {losses}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    h_avg = fl_loop.run_federated(task, algorithms.make("fedavg"), data,
                                  device=dev, rounds=1, **kw)
    r = h_avg.records[0]
    log(f"FedAvg: round 1 {r.seconds:.3f} s test_acc {r.test_acc:.4f} "
        f"local_loss {r.mean_local_loss:.4f}")
    if not (math.isfinite(r.mean_local_loss) and all_finite(h_avg.final_params)):
        raise AssertionError("FedAvg: non-finite loss or params")
    profile_round(dev, task, data, kw, fedgkd)

    t0 = time.perf_counter()
    h_cpu = fl_loop.run_federated(task, fedgkd(), data, device="cpu",
                                  rounds=1, **kw)
    cpu = tree_leaves(params_to_numpy(h_cpu.final_params))
    card = tree_leaves(first_round["params"])
    diff = max(float(abs(a - b).max()) for a, b in zip(cpu, card, strict=True))
    log(f"first round card vs CPU ({time.perf_counter() - t0:.1f} s on the "
        f"CPU): max abs param diff {diff:.3e} (limit {ROUND_TOL})")
    if not diff < ROUND_TOL:
        raise AssertionError(f"card and CPU disagree after one round: {diff}")
    return launches, hist


def main() -> int:
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
        if "Used" in line or line.startswith("=="):
            log("  " + line.strip())

    task, data, kw = main_path_setup()
    chunks = teacher_chunks(task, data, kw["seed"])
    log(f"kernels against their plain versions (fp32, TF32 off; device "
        f"time of CUDA-graph replays); teacher chunks of round 1: {chunks}")
    kernels = check_kd_kl(dev) + [check_conv(dev, chunks)]
    launches, _ = run_main_path(dev, task, data, kw)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
