"""The port's spans (``repro_torch.trace``) on the CPU.

Off and with no profiler a span is a shared no-op; enabled, spans are kept
with the innermost open span of their own thread as parent; under a
profiler each span is one range of its name, and its kept interval lies
on the profiler's clock.  A FedGKD round of ``run_federated`` on the
client-batched body and one of ``run_serial`` give the spans the
benchmark's readers count: a step a batch with its forward, backward and
optimizer, the teacher once a round (the precompute) or once a step
(``launch.steps``), and the round's data.
"""
import collections
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs import get_smoke_config
from repro_torch.configs.paper import CIFAR10
from repro_torch.core import algorithms, fl_loop
from repro_torch.data.pipeline import ClientData, FederatedData
from repro_torch.kernels.grouped_conv.ops import client_batched_conv
from repro_torch.launch import train
from torch_threads import one_torch_thread  # noqa: F401

STEP = ("step", "step_forward", "step_backward", "step_optimizer")


@pytest.fixture(autouse=True)
def clean_record():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _counts(spans) -> collections.Counter:
    return collections.Counter(s[0] for s in spans)


def test_off_is_a_shared_noop(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name))
    assert trace.span("a") is trace.span("b")
    with trace.span("step"):
        pass
    assert made == [] and trace.drain() == []


def test_spans_nest_by_thread():
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            done = threading.Event()

            def other():
                with trace.span("t_outer"):
                    with trace.span("t_inner"):
                        pass
                done.set()

            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive() and done.is_set()
        with trace.span("second"):
            pass
    trace.disable()
    with trace.span("after"):
        pass
    spans = trace.drain()
    names = [s[0] for s in spans]
    assert names == ["outer", "inner", "t_outer", "t_inner", "second"]
    parent = {s[0]: (names[s[3]] if s[3] >= 0 else None) for s in spans}
    assert parent == {"outer": None, "inner": "outer", "t_outer": None,
                      "t_inner": "t_outer", "second": "outer"}
    assert spans[0][4] == spans[1][4] == threading.get_ident()
    assert spans[2][4] == spans[3][4] != spans[0][4]
    for name, start, end, _, _ in spans:
        assert start <= end, name
    assert spans[0][1] <= spans[1][1] <= spans[1][2] <= spans[0][2]
    assert trace.drain() == []


@pytest.mark.parametrize("keep", [False, True])
def test_a_span_is_one_profiler_range_on_its_clock(keep):
    if keep:
        trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in ("first", "second"):
            with trace.span(name):
                time.sleep(0.025)
    trace.disable()
    results = prof.profiler.kineto_results
    ranges = {e.name(): e for e in results.events()
              if e.name() in ("first", "second")}
    assert collections.Counter(
        e.name() for e in results.events()
        if e.name() in ("first", "second")) == {"first": 1, "second": 1}
    spans = trace.drain()
    if not keep:
        assert spans == []
        return
    assert [s[0] for s in spans] == ["first", "second"]
    for name, start, end, _, _ in spans:
        e = ranges[name]
        assert end - start >= 20e6
        assert abs(start - e.start_ns()) < 1e6, name
        assert abs(end - e.end_ns()) < 1e6, name


def test_conv_gradient_ranges_with_tracing_off():
    x = torch.randn(2, 3, 6, 6, 4, requires_grad=True)
    w = torch.randn(2, 3, 3, 4, 5, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        client_batched_conv(x, w).sum().backward()
    names = collections.Counter(e.name for e in prof.events())
    assert names["grouped_conv_dw"] == 1 and names["grouped_conv_dx"] == 1
    assert trace.drain() == []


def _cv_data(rng):
    def shard(n):
        return ClientData(rng.standard_normal((n, 8, 8, 3)).astype(np.float32),
                          rng.integers(0, 10, n).astype(np.int64))
    return FederatedData([shard(n) for n in (30, 26, 40, 33)],
                         rng.standard_normal((16, 8, 8, 3)).astype(np.float32),
                         rng.integers(0, 10, 16), np.zeros((4, 10)))


def test_run_federated_round_spans():
    task = dataclasses.replace(CIFAR10, train_size=129, n_clients=4,
                               participation=0.5, batch_size=8, image_hw=8,
                               local_epochs=1)
    steps, rounds = 3, 2
    trace.enable()
    hist = fl_loop.run_federated(task, algorithms.make("fedgkd"),
                                 _cv_data(np.random.default_rng(0)),
                                 rounds=rounds, seed=0,
                                 max_batches_per_client=steps, width=8,
                                 device="cpu")
    trace.disable()
    assert hist.telemetry["round_body"] == "client_batched"
    spans = trace.drain()
    n = _counts(spans)
    assert {k: n[k] for k in STEP} == dict.fromkeys(STEP, rounds * steps)
    assert n["teacher"] == rounds and n["data"] == 2 * rounds
    assert n["grouped_conv_dw"] % (rounds * steps) == 0
    names = [s[0] for s in spans]
    for name, _, _, parent, _ in spans:
        if name in STEP[1:]:
            assert names[parent] == "step"
        elif name in ("step", "teacher", "data"):
            assert parent == -1


def test_run_serial_round_spans():
    cfg = get_smoke_config("phi4-mini-3.8b")
    clients, batches = 2, 2
    trace.enable()
    train.run_serial(cfg, rounds=1, n_clients=clients,
                     batches_per_round=batches, batch=2, seq=9, algo="fedgkd",
                     device="cpu", verbose=False)
    trace.disable()
    spans = trace.drain()
    n = _counts(spans)
    steps = clients * batches
    assert {k: n[k] for k in STEP} == dict.fromkeys(STEP, steps)
    assert n["teacher"] == steps and n["data"] == 1 + steps
    names = [s[0] for s in spans]
    for name, _, _, parent, _ in spans:
        if name == "teacher":
            assert names[parent] == "step_forward"
