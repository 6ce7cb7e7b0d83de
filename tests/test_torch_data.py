"""The port's data pipeline draws the reference's arrays, byte for byte.

Same seed, same arrays: the synthetic image task, the Dirichlet partition,
the cohort draw and the batch picks (the numpy generator consumed in the
same order and count).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs.paper import CIFAR10 as JAX_CIFAR10  # noqa: E402
from repro.core import executor as jax_executor  # noqa: E402
from repro.data import dirichlet as jax_dirichlet  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro_torch.configs.paper import CIFAR10, scaled  # noqa: E402
from repro_torch.core import executor, fl_loop  # noqa: E402
from repro_torch.data import dirichlet, pipeline, synthetic  # noqa: E402


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_make_task_data_is_byte_identical():
    kw = dict(image_hw=16, train_size=120)
    jtask = dataclasses.replace(JAX_CIFAR10, **kw)
    task = dataclasses.replace(CIFAR10, **kw)
    for a, b in zip(jax_synthetic.make_task_data(jtask, 120, 30, seed=3),
                    synthetic.make_task_data(task, 120, 30, seed=3), strict=True):
        _same(a, b)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 1.0])
def test_dirichlet_partition_is_identical(alpha):
    labels = np.random.default_rng(0).integers(0, 10, 500)
    want = jax_dirichlet.dirichlet_partition(labels, 20, alpha, seed=4)
    got = dirichlet.dirichlet_partition(labels, 20, alpha, seed=4)
    for a, b in zip(want, got, strict=True):
        _same(a, b)
    _same(jax_dirichlet.partition_stats(labels, want),
          dirichlet.partition_stats(labels, got))


def test_federated_data_and_cohorts_and_picks_are_identical():
    task = scaled(CIFAR10, 0.01)
    jtask = dataclasses.replace(JAX_CIFAR10, train_size=task.train_size)
    xtr, ytr, xte, yte = synthetic.make_task_data(task, task.train_size, 50)
    jdata = jax_pipeline.FederatedData.from_arrays(xtr, ytr, xte, yte, 20,
                                                   0.5, seed=1)
    data = pipeline.FederatedData.from_arrays(xtr, ytr, xte, yte, 20, 0.5,
                                              seed=1)
    _same(jdata.label_matrix, data.label_matrix)
    for a, b in zip(jdata.clients, data.clients, strict=True):
        _same(a.x, b.x)
        _same(a.y, b.y)
    assert fl_loop.make_federated_data(task, 0.5, seed=2).total_n == \
        task.train_size == jtask.train_size

    jrng, rng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):                  # cohort, then each client's picks
        jc, c = jdata.sample_cohort(jrng, 4), data.sample_cohort(rng, 4)
        _same(jc, c)
        for cid in c:
            for mb in (None, 3):
                _same(jax_executor.materialize_picks(
                          jrng, jdata.clients[cid], 64, 2, mb),
                      executor.materialize_picks(
                          rng, data.clients[cid], 64, 2, mb))
    _same(jrng.random(4), rng.random(4))    # streams still in lockstep


def test_num_batches_matches():
    for n, b, e in ((5, 8, 1), (64, 64, 2), (65, 64, 3), (1, 64, 1)):
        assert pipeline.num_batches(n, b, e) == jax_pipeline.num_batches(n, b, e)
