"""The port's optimizers against the reference's, on the CPU.

Five steps from the same params and gradients (numpy, from a seed): the
params and the optimizer state agree within 1e-6 (fp32, elementwise
arithmetic in the same order).  Weight decay is the reference code's:
coupled L2 in ``sgd``, added after bias correction in ``adam``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.optim import optimizers as jax_optim  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-6
CONFIGS = [
    ("sgd", dict()),
    ("sgd", dict(momentum=0.9, weight_decay=1e-2)),
    ("sgd", dict(momentum=0.9, nesterov=True)),
    ("adam", dict()),
    ("adam", dict(weight_decay=1e-2)),
]


def _tree(rng, lead=()):
    return {"w": rng.standard_normal(lead + (4, 3)).astype(np.float32),
            "gn": {"scale": rng.standard_normal(lead + (3,)).astype(np.float32)}}


def _max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(b), strict=True))


@pytest.mark.parametrize("name,kw", CONFIGS, ids=lambda c: str(c))
def test_optimizer_steps_match_reference(name, kw):
    rng = np.random.default_rng(0)
    init = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    jopt, opt = getattr(jax_optim, name)(**kw), getattr(optim, name)(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    js = jopt.init(jp)
    p = bridge.params_from_numpy(init)
    s = opt.init(p)
    for g in grads:
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, 0.1)
        jp = jax_optim.apply_updates(jp, ju)
        with torch.no_grad():
            u, s = opt.update(bridge.params_from_numpy(g), s, p, 0.1)
            p = optim.apply_updates(p, u)
        assert _max_diff(bridge.params_to_numpy(p), jp) < TOL
    if name == "adam":
        assert int(s.count) == int(js.count) == len(grads)
        assert _max_diff(bridge.params_to_numpy(s.mu), js.mu) < TOL
        assert _max_diff(bridge.params_to_numpy(s.nu), js.nu) < TOL


def test_adam_client_stacked_matches_per_client():
    """``init(params, lead=(K,))`` keeps one step count per client: a stacked
    Adam over K clients steps each client as its own Adam would."""
    rng = np.random.default_rng(1)
    k = 3
    stacked = _tree(rng, lead=(k,))
    grads = [_tree(rng, lead=(k,)) for _ in range(3)]
    opt = optim.adam(weight_decay=1e-2)
    p = bridge.params_from_numpy(stacked)
    s = opt.init(p, lead=(k,))
    assert tuple(s.count.shape) == (k,)
    singles = [tree_map(lambda t, i=i: t[i].clone(), p) for i in range(k)]
    states = [opt.init(q) for q in singles]
    with torch.no_grad():
        for g in grads:
            gt = bridge.params_from_numpy(g)
            u, s = opt.update(gt, s, p, 0.1)
            p = optim.apply_updates(p, u)
            for i in range(k):
                ui, states[i] = opt.update(tree_map(lambda t: t[i], gt),
                                           states[i], singles[i], 0.1)
                singles[i] = optim.apply_updates(singles[i], ui)
    for i in range(k):
        for a, b in zip(tree_leaves(p), tree_leaves(singles[i]), strict=True):
            torch.testing.assert_close(a[i], b, rtol=0, atol=TOL)
