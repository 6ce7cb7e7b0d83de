"""What the port's spans read (``cardbench/spans.py``): the attribution
on fabricated timelines, the readers' counts, and on the CPU the three
metrics the harness's ranges give, which read nothing from a port without
spans while every other metric reads as before."""
import contextlib
import random
import types

import pytest
import torch

import cells
from cardbench import harness, spans

MAIN, AUTOGRAD = 1, 2
# one step on the main thread, its backward's kernels launched from the
# autograd engine's thread, where the conv gradient's range opens
STEP = [("step", 0, 100, MAIN), ("step_forward", 1, 30, MAIN),
        ("teacher", 5, 15, MAIN), ("step_backward", 31, 80, MAIN),
        ("grouped_conv_dw", 40, 50, AUTOGRAD),
        ("step_optimizer", 81, 99, MAIN), ("data", 101, 120, MAIN)]


def _run(entry="run_serial", profile_rounds=1, **profile):
    traffic = ({"max_batches_per_client": 1} if entry == "fl_loop"
               else {"clients": 1, "batches_per_round": 1})
    return types.SimpleNamespace(
        cell=types.SimpleNamespace(workload={"entry": entry}),
        traffic=traffic, profile_rounds=profile_rounds, profile=profile)


def _device_s(activities):
    ranges = spans.nest(STEP)
    dev = spans.device_by_span(activities, ranges)
    return {p: v / 1e9 for p, v in spans.by_path(
        ranges, spans.adopt(ranges), dev).items()}


def test_nest_and_adopt():
    s = spans.nest(STEP)
    names = [x[0] for x in s]
    parent = {x[0]: names[p] if p >= 0 else None
              for x, p in zip(s, spans.adopt(s))}
    assert parent == {"step": None, "step_forward": "step",
                      "teacher": "step_forward", "step_backward": "step",
                      "grouped_conv_dw": "step_backward",
                      "step_optimizer": "step", "data": None}
    assert s[names.index("grouped_conv_dw")][3] == -1


def test_a_kernel_launched_on_the_autograd_thread_goes_to_backward():
    acts = [(200, 210, AUTOGRAD, 45),    # inside grouped_conv_dw
            (210, 230, AUTOGRAD, 60),    # autograd thread, no span open
            (230, 233, MAIN, 20),        # the step's forward
            (233, 240, MAIN, 8),         # the teacher inside it
            (240, 245, MAIN, 90),        # the optimizer
            (245, 250, MAIN, 110),       # data
            (250, 251, None, 200)]       # launched outside every span
    got = _device_s(acts)
    run = _run(span_device_s=got, span_counts={"step": 1, "teacher": 1,
                                               "step_forward": 1,
                                               "step_backward": 1,
                                               "step_optimizer": 1})
    assert spans.device_ms(run, "step_backward", "step") == \
        pytest.approx(30e-9 * 1e3)
    assert spans.device_ms(run, "step_forward", "step") == \
        pytest.approx(3e-9 * 1e3)
    assert spans.device_ms(run, "teacher", "teacher") == \
        pytest.approx(7e-9 * 1e3)
    assert spans.device_ms(run, "step_optimizer", "step") == \
        pytest.approx(5e-9 * 1e3)
    assert got[()] == pytest.approx(1e-9)
    # a count the traffic does not imply reads nothing
    run.profile["span_counts"]["step_backward"] = 2
    assert spans.device_ms(run, "step_backward", "step") is None
    run.profile_rounds = 2
    assert spans.device_ms(run, "step_forward", "step") is None


class _Event:
    """A profiler event as ``torch.profiler`` hands it over."""

    def __init__(self, name, device, start, end, corr, link, thread,
                 annotation=False):
        self._v = dict(name=name, device_type=device, start_ns=start,
                       end_ns=end, correlation_id=corr,
                       linked_correlation_id=link, start_thread_id=thread,
                       is_user_annotation=annotation)

    def __getattr__(self, key):
        return lambda: self._v[key]


def test_launches_follow_the_correlation_to_the_host_operation():
    cpu, cuda = spans.CPU, spans.CUDA
    events = [
        _Event("step_backward", cpu, 0, 100, 1, 0, MAIN, True),
        _Event("aten::mm", cpu, 10, 20, 3, 0, AUTOGRAD),
        # the profiler's own work under the id of the operation it
        # interrupted, later than that operation
        _Event("Activity Buffer Request", cpu, 15, 16, 3, 0, MAIN),
        _Event("cuLaunchKernel", cpu, 12, 13, 900, 3, AUTOGRAD),
        _Event("gemm", cuda, 30, 40, 900, 3, 0),
        _Event("step_backward", cuda, 30, 60, 1, 0, 0, True),
        _Event("Memcpy HtoD", cuda, 50, 55, 901, 0, 0)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert spans.launches(prof) == [(30, 40, AUTOGRAD, 10),
                                    (50, 55, None, 50)]
    assert spans.device_intervals(prof) == [(30, 40), (50, 55)]
    assert spans.profile_spans(prof) == [("step_backward", 0, 100, -1,
                                          MAIN)]


def test_a_gap_in_data_goes_to_data_idle():
    kept = spans.nest(STEP)
    intervals = [(0, 20), (25, 60), (70, 100), (108, 112)]
    idle = spans.idle_by_span(intervals, kept, 0, 130)
    got = {p: v / 1e9 for p, v in spans.by_path(
        kept, spans.adopt(kept), idle).items()}
    # (20, 25) in the forward, (60, 70) in the backward: the step's;
    # (100, 108) and (112, 130): middles 104 and 121, data and none
    assert got == {("step", "step_forward"): 5e-9,
                   ("step", "step_backward"): 10e-9, ("data",): 8e-9,
                   (): 18e-9}
    run = _run(span_idle_s=got, span_idle_counts={"step": 1, "data": 2})
    assert spans.idle_ms(run, "step") == pytest.approx(15e-6)
    assert spans.idle_ms(run, "data") == pytest.approx(8e-6)
    run.profile["span_idle_counts"]["data"] = 3
    assert spans.idle_ms(run, "data") is None


@pytest.mark.parametrize("seed", range(20))
def test_idle_is_never_more_than_wall_minus_busy(seed):
    rng = random.Random(seed)
    kept, t = [], 0
    for _ in range(6):
        a = t + rng.randint(0, 20)
        b = a + rng.randint(1, 60)
        name = rng.choice(["step", "data", "teacher"])
        kept.append((name, a, b, MAIN))
        if name == "step":
            m = rng.randint(a, b)
            kept.append(("step_backward", a, m, MAIN))
            kept.append(("grouped_conv_dw", a, rng.randint(a, m), AUTOGRAD))
        t = b
    kept = spans.nest(kept)
    intervals = sorted((a, a + rng.randint(0, 30))
                       for a in (rng.randint(-20, t + 20) for _ in range(25)))
    lo, hi = 0, t
    idle = spans.idle_by_span(intervals, kept, lo, hi)
    clipped = [(max(a, lo), min(b, hi)) for a, b in intervals
               if b > lo and a < hi]
    busy = spans._union_ns(clipped)
    assert sum(idle.values()) == hi - lo - busy
    paths = spans.by_path(kept, spans.adopt(kept), idle)
    step = sum(v for p, v in paths.items() if "step" in p)
    data = sum(v for p, v in paths.items() if "data" in p)
    assert step + data <= hi - lo - busy


def test_range_readers_count_the_traffic():
    from cardbench.metrics import forward_ms, optimizer_ms, teacher_ms

    # phi's: the teacher forward inside each step's forward
    run = _run(ranges={"step_forward": (0.5, 2), "teacher": (0.2, 2),
                       "step_optimizer": (0.1, 2)}, profile_rounds=2)
    run.traffic.update(clients=1, batches_per_round=1)
    assert forward_ms.read(run) == pytest.approx(150.0)
    assert teacher_ms.read(run) == pytest.approx(100.0)
    assert optimizer_ms.read(run) == pytest.approx(50.0)
    # ResNet-8's: the teacher's precompute outside the steps, once a round
    run = _run("fl_loop", ranges={"step_forward": (0.5, 1),
                                  "teacher": (0.2, 1)})
    assert forward_ms.read(run) == pytest.approx(500.0)
    assert teacher_ms.read(run) == pytest.approx(200.0)
    run.traffic["max_batches_per_client"] = 2
    assert forward_ms.read(run) is None
    assert forward_ms.read(_run(ranges={})) is None


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NEW = ("forward_ms", "optimizer_ms", "teacher_ms")


@pytest.mark.parametrize("name", ["resnet8-cifar10.fedgkd",
                                  "phi4-mini.fedgkd"])
def test_a_port_without_spans_reads_nothing_new(name, monkeypatch,
                                                few_threads):
    cell = cells.small_cell(name)
    if cell.workload["entry"] == "run_serial":
        cells.patch_lm_config(monkeypatch, cell)
    with_spans = harness.run_cell(cell, 2 ** 34 + 7, 2.0, True, "cpu")
    # the CPU's trace has no device time: the counts are what is read
    assert {k: with_spans["metrics"][k]["value"] for k in NEW} == \
        dict.fromkeys(NEW, 0.0)
    from repro_torch import trace

    monkeypatch.setattr(trace, "span", lambda n: contextlib.nullcontext())
    without = harness.run_cell(cell, 2 ** 34 + 7, 2.0, True, "cpu")
    assert without["correct"] and with_spans["correct"]
    assert not set(NEW) & set(without["metrics"])
    assert set(without["metrics"]) == set(with_spans["metrics"]) - set(NEW)
