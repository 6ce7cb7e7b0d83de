"""The port's ResNet-50 (the paper's Tiny-ImageNet backbone) against the
reference's, from bridged parameters, on the CPU.

Units first: the SAME max-pool (JAX pads ``lo = pad // 2`` with -inf and
the rest after) on NHWC with and without the client axes and under
``torch.func.vmap``, and the bottleneck at stride 1 and 2, with and without
its projection.  Then the whole network at 16x16 images, N=2: logits and
every parameter's gradient for one client (the reference's ``lax.conv``)
and for K=2 stacked clients (the reference's grouped conv through its jnp
oracle, the port's through ``client_batched_conv``).  Last, one FedGKD
round of ``run_federated`` on a 2-client Tiny-ImageNet cut at 16x16 in both
packages from the reference's init.  Bar: 1e-5 of max|reference|.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.paper import TINY_IMAGENET as JAX_TINY  # noqa: E402
from repro.core import algorithms as jax_algorithms  # noqa: E402
from repro.core import fl_loop as jax_fl  # noqa: E402
from repro.data.pipeline import ClientData as JaxClientData  # noqa: E402
from repro.data.pipeline import FederatedData as JaxFederatedData  # noqa: E402
from repro.data.synthetic import SyntheticImageTask  # noqa: E402
from repro.models import resnet as jax_resnet  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.paper import PAPER_TASKS, TINY_IMAGENET  # noqa: E402
from repro_torch.core import algorithms, fl_loop, modelzoo  # noqa: E402
from repro_torch.data.pipeline import ClientData, FederatedData  # noqa: E402
from repro_torch.models import layers, resnet  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

REL = 1e-5          # of max |reference|
C = 200


def close(got, want, what=""):
    """max|got - want| <= REL x max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    bar = REL * float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= bar, f"{what}: {err:.3e} > {bar:.3e}"


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_tiny_imagenet_task_matches_reference():
    assert dataclasses.asdict(TINY_IMAGENET) == dataclasses.asdict(JAX_TINY)
    assert PAPER_TASKS["tiny-imagenet"] is TINY_IMAGENET
    m = modelzoo.make_model(TINY_IMAGENET)
    assert (m.name, m.client_batched, m.vmap_friendly) == (
        "resnet50", True, False)


# ------------------------------------------------------------------ max-pool

def _jax_pool(x):
    lead = (1,) * (x.ndim - 3)
    return jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 lead + (3, 3, 1), lead + (2, 2, 1), "SAME")


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (3, 7, 9, 2), (2, 3, 4, 4, 5),
                                   (2, 1, 1, 3)])
def test_max_pool_matches_reduce_window(shape):
    x = _x(shape, 0)
    got = layers.max_pool_same(torch.from_numpy(x), 3, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax_pool(x)))


def test_max_pool_under_vmap_and_its_gradient():
    x = _x((3, 2, 8, 8, 4), 1)
    got = torch.func.vmap(lambda t: layers.max_pool_same(t, 3, 2))(
        torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax_pool(x)))
    g = torch.func.grad(lambda t: (layers.max_pool_same(t, 3, 2) ** 2).sum())(
        torch.from_numpy(x[0]))
    want = jax.grad(lambda t: jnp.sum(_jax_pool(t) ** 2))(jnp.asarray(x[0]))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- bottleneck

@pytest.mark.parametrize("cin,cmid,stride", [(64, 16, 1), (32, 16, 1),
                                             (32, 16, 2), (64, 32, 2)],
                         ids=["identity-s1", "proj-s1", "proj-s2",
                              "proj-s2-wide"])
def test_bottleneck_matches_reference(cin, cmid, stride):
    """The network's bottlenecks: a stride-2 block always projects."""
    p = _np(jax_resnet.bottleneck_init(jax.random.PRNGKey(3), cin, cmid))
    assert ("proj" in p) == (cin != 4 * cmid)
    fwd = jax.jit(jax_resnet.bottleneck, static_argnums=2)
    x = _x((2, 8, 8, cin), 4)
    close(resnet.bottleneck(bridge.params_from_numpy(p), torch.from_numpy(x),
                            stride).detach(), fwd(p, x, stride), "single")
    # K=2 stacked: the reference's grouped conv (its jnp oracle here)
    ps = jax.tree_util.tree_map(lambda a: np.stack([a, 0.5 * a]), p)
    xs = _x((2, 2, 8, 8, cin), 5)
    out = resnet.bottleneck(bridge.params_from_numpy(ps),
                            torch.from_numpy(xs), stride).detach()
    assert out.shape == (2, 2, 8 // stride, 8 // stride, 4 * cmid)
    close(out, fwd(ps, xs, stride), "stacked")


# ------------------------------------------------------------ whole network

@pytest.fixture(scope="module")
def r50():
    """(single init, K=2 stacked init) of the reference, as numpy; the
    second client's is ``run_federated``'s init at seed 0 (key seed + 1)."""
    init = jax.jit(lambda k: jax_resnet.resnet50_init(k, C))
    one = _np(init(jax.random.PRNGKey(0)))
    two = _np(init(jax.random.PRNGKey(1)))
    return one, jax.tree_util.tree_map(lambda a, b: np.stack([a, b]), one, two)


def _loss_and_grads_ref(params, x, y):
    def loss(p):
        logits = jax_resnet.resnet50_apply(p, x)
        return jnp.sum(jax.nn.log_softmax(logits)[..., 0] * y), logits

    (_, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(logits), _np(g)


def _loss_and_grads_port(params, x, y):
    tparams = bridge.params_from_numpy(params)
    flat = [t.requires_grad_(True) for t in tree_leaves(tparams)]
    logits = resnet.resnet50_apply(tparams, torch.from_numpy(x))
    loss = torch.sum(torch.log_softmax(logits, -1)[..., 0]
                     * torch.from_numpy(y))
    grads = torch.autograd.grad(loss, flat)
    return logits.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("stacked", [False, True], ids=["K=1", "K=2"])
def test_resnet50_logits_and_gradients_match_reference(r50, stacked):
    params = r50[1] if stacked else r50[0]
    lead = (2, 2) if stacked else (2,)
    x = _x(lead + (16, 16, 3), 6)
    y = _x(lead, 7)
    want_logits, want_g = _loss_and_grads_ref(params, x, y)
    got_logits, got_g = _loss_and_grads_port(params, x, y)
    assert got_logits.shape == lead + (C,)
    close(got_logits, want_logits, "logits")
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(want_g)[0]]
    for path, g, w in zip(paths, got_g, jax.tree_util.tree_leaves(want_g),
                          strict=True):
        close(g, w, jax.tree_util.keystr(path))


def test_resnet50_init_matches_reference_structure():
    mine = resnet.resnet50_init(torch.Generator().manual_seed(0), C,
                                projection_head=True)
    for head in (True, False):
        ref = jax.eval_shape(lambda h=head: jax_resnet.resnet50_init(
            jax.random.PRNGKey(0), C, projection_head=h))
        ours = (mine if head else
                resnet.resnet50_init(torch.Generator().manual_seed(0), C))
        assert ([tuple(t.shape) for t in tree_leaves(ours)]
                == [a.shape for a in jax.tree_util.tree_leaves(ref)])
    assert sum(t.numel() for t in tree_leaves(ours)) == 23_910_152
    # the stem's trunc-normal at sqrt(2 / fan_in)
    std = float(mine["stem"]["w"].std())
    assert abs(std / np.sqrt(2.0 / (7 * 7 * 3)) - 0.88) < 0.05


# ------------------------------------------------------- one FedGKD round

CUT = dict(n_clients=2, participation=1.0, batch_size=4, rounds=1,
           local_epochs=1, image_hw=16)


def test_fedgkd_round_on_tiny_imagenet_cut_matches_reference(monkeypatch, r50):
    """2 clients x 2 steps of batch 4 at 16x16, the vmap executor's
    client-batched route in both packages."""
    jtask = dataclasses.replace(JAX_TINY, **CUT)
    task = dataclasses.replace(TINY_IMAGENET, **CUT)
    gen = SyntheticImageTask(C, hw=16, seed=0)
    shards = [gen.generate(n, seed=200 + i) for i, n in enumerate((7, 8))]
    tx, ty = gen.generate(8, seed=998)
    lm = np.zeros((2, C))
    jdata = JaxFederatedData([JaxClientData(x, y) for x, y in shards], tx, ty,
                             lm)
    data = FederatedData([ClientData(x, y) for x, y in shards], tx, ty, lm)
    init = jax.tree_util.tree_map(lambda a: a[1], r50[1])
    real = modelzoo.make_model

    def with_reference_init(*args, **kw):
        return dataclasses.replace(
            real(*args, **kw), init=lambda g: bridge.params_from_numpy(init))

    monkeypatch.setattr(fl_loop, "make_model", with_reference_init)
    kw = dict(seed=0, max_batches_per_client=2)
    hj = jax_fl.run_federated(jtask, jax_algorithms.make("fedgkd", gamma=0.1),
                              jdata, **kw)
    ht = fl_loop.run_federated(task, algorithms.make("fedgkd", gamma=0.1),
                               data, device="cpu", **kw)
    assert ht.telemetry["route"] == hj.telemetry["route"] == "vmap"
    assert ht.telemetry["round_body"] == hj.telemetry["round_body"] \
        == "client_batched"
    (rt,), (rj,) = ht.records, hj.records
    assert rt.sampled == rj.sampled
    assert abs(rt.mean_local_loss - rj.mean_local_loss) <= REL * abs(
        rj.mean_local_loss)
    assert abs(rt.test_loss - rj.test_loss) <= REL * abs(rj.test_loss)
    got = bridge.params_to_numpy(ht.final_params)
    moved = 0.0
    for g, w, i in zip(tree_leaves(got),
                       jax.tree_util.tree_leaves(hj.final_params),
                       jax.tree_util.tree_leaves(init), strict=True):
        close(g, w, "final params")
        moved = max(moved, float(np.max(np.abs(np.asarray(w) - i))))
    assert moved > 1e-4
    assert all(np.isfinite(t).all() for t in tree_leaves(got))
