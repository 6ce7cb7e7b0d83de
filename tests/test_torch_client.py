"""The client-batched local update: a masked step is an exact identity.

A client whose step is masked off keeps its params and its optimizer
state bit for bit, while the other clients of the cohort step; a cohort
of K clients steps each client as if it trained alone.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.paper import CIFAR10  # noqa: E402
from repro_torch.core import algorithms, client, modelzoo  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

K, S, B, HW = 3, 3, 4, 8


@pytest.fixture(scope="module")
def setup():
    task = dataclasses.replace(CIFAR10, image_hw=HW)
    model = modelzoo.make_model(task, width=8)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((K, S, B, HW, HW, 3))
                          .astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, (K, S, B)))
    update = client.make_batched_local_update(
        algorithms.make("fedavg").batched_loss_fn(model),
        sgd(momentum=0.9, weight_decay=1e-5))
    return params, xs, ys, update


def _run(update, params, xs, ys, step_mask):
    ex_mask = torch.ones(xs.shape[:3])
    return update(params, (), (), xs, ys, ex_mask, (), step_mask, 0.1)


def test_masked_step_is_an_exact_identity(setup):
    params, xs, ys, update = setup
    # client 1 skips step 1: its params AND momentum carry through it
    # untouched, so it ends where training on steps 0 and 2 alone ends
    mask = torch.tensor([[True, True, True], [True, False, True],
                         [True, True, True]])
    masked, _ = _run(update, params, xs, ys, mask)
    keep = [0, 2]
    skipped, _ = _run(update, params, xs[:, keep], ys[:, keep], mask[:, keep])
    for a, b in zip(tree_leaves(masked), tree_leaves(skipped), strict=True):
        assert torch.equal(a[1], b[1])
        assert not torch.equal(a[0], b[0])
    # a client with no live step keeps the global params bit for bit and
    # reports a zero mean loss
    none = mask.clone()
    none[1] = False
    out, loss = _run(update, params, xs, ys, none)
    for a, g in zip(tree_leaves(out), tree_leaves(params), strict=True):
        assert torch.equal(a[1], g)
    assert float(loss[1]) == 0.0


def test_cohort_steps_each_client_as_alone(setup):
    params, xs, ys, update = setup
    live = torch.ones(K, S, dtype=torch.bool)
    cohort, loss = _run(update, params, xs, ys, live)
    for k in range(K):
        alone, loss_k = _run(update, params, xs[k:k + 1], ys[k:k + 1],
                             live[k:k + 1])
        for a, b in zip(tree_leaves(cohort), tree_leaves(alone), strict=True):
            torch.testing.assert_close(a[k], b[0], rtol=0, atol=1e-6)
        assert abs(float(loss[k]) - float(loss_k[0])) < 1e-6
