"""The port's ResNet-8 against the reference's, from bridged parameters.

The reference's initialisation goes through the bridge into the port; the
logits must agree within 1e-5 (fp32) for one client and for K stacked
clients, and the bridge must round-trip bitwise.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.paper import CIFAR10 as JAX_CIFAR10  # noqa: E402
from repro.core.modelzoo import make_model as jax_make_model  # noqa: E402
from repro.models import resnet as jax_resnet  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
K = 3


@pytest.fixture(scope="module")
def params():
    task = dataclasses.replace(JAX_CIFAR10, image_hw=16)
    init = jax.jit(jax_make_model(task, width=8).init)
    single = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    stacked = jax.tree_util.tree_map(
        lambda *xs: np.stack(xs),
        *[jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(i)))
          for i in range(K)])
    return single, stacked


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_resnet8_single_client_matches_reference(params):
    single, _ = params
    x = _x((5, 16, 16, 3))
    want = jax.jit(jax_resnet.resnet8_apply)(single, jnp.asarray(x))
    with torch.no_grad():
        got = resnet.resnet8_apply(bridge.params_from_numpy(single),
                                   torch.from_numpy(x))
    assert got.shape == (5, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_resnet8_stacked_clients_match_reference(params):
    _, stacked = params
    x = _x((K, 4, 16, 16, 3), seed=1)
    want = jax.jit(jax_resnet.resnet8_apply)(stacked, jnp.asarray(x))
    with torch.no_grad():
        got = resnet.resnet8_apply(bridge.params_from_numpy(stacked),
                                   torch.from_numpy(x))
    assert got.shape == (K, 4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_stacked_route_equals_per_client_route(params):
    """Client k of the stacked forward is the single-client forward with
    client k's params (no cross-client mixing)."""
    _, stacked = params
    p = bridge.params_from_numpy(stacked)
    x = torch.from_numpy(_x((K, 2, 16, 16, 3), seed=2))
    with torch.no_grad():
        both = resnet.resnet8_apply(p, x)
        for k in range(K):
            one = resnet.resnet8_apply(
                jax.tree_util.tree_map(lambda t: t[k], p), x[k])
            torch.testing.assert_close(both[k], one, rtol=0, atol=TOL)


def test_bridge_round_trip_is_bitwise(params):
    single, stacked = params
    for tree in (single, stacked):
        back = bridge.params_to_numpy(bridge.params_from_numpy(tree))
        la, lb = jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)
        assert jax.tree_util.tree_structure(tree) == \
            jax.tree_util.tree_structure(back)
        for a, b in zip(la, lb, strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


def test_port_init_matches_reference_shapes_and_scale(params):
    """Same keys, shapes and dtypes as the reference's init; conv filters
    truncated at ±2 std (absolute bounds)."""
    single, _ = params
    mine = bridge.params_to_numpy(
        resnet.resnet8_init(torch.Generator().manual_seed(0), 10, width=8))
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(single)
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(single), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
    w = mine["block1"]["conv1"]["w"]
    std = np.sqrt(2.0 / (3 * 3 * 8))
    assert np.abs(w).max() <= 2 * std + 1e-7
    assert 0.5 * std < w.std() < std
