"""The port's algorithms, one piece at a time, against the JAX reference.

On one batch of the ragged fixture (``tests/test_torch_baselines_batched.py``:
16x16 images, ResNet-8 at width 8) with a mask that drops examples, from the
reference's initialisation carried over by the bridge:

* every algorithm's ``loss_fn``: value and gradient;
* every ``batched_loss_fn``: per-client values against ``loss_fn`` run
  client by client, and against the reference's;
* ``param_sq_dist*``, ``kd_loss_mse`` and ``vote_coefficients``;
* FedGKD-VOTE's payload padding, and ``precompute_combine(parts)`` against
  ``precompute_aux``;
* MOON with an all-zero feature row (the gradient stays finite);
* FedDistill+'s ``client_finalize`` and ``server_update``, SCAFFOLD's
  participation fraction and FedDyn's dual update;
* FedGen's loss and generator step, with the reference's draws injected;
* the projection-head ResNet-8 and text classifier;
* the executor ``"auto"`` picks for each algorithm, and ``available()``.

Tolerance: 1e-5 absolute (fp32, different summation orders), as the
reference's own equivalence tests.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs.paper import AG_NEWS as JAX_AG_NEWS  # noqa: E402
from repro.core import algorithms as jax_algorithms  # noqa: E402
from repro.core import distillation as JD  # noqa: E402
from repro.core import executor as jax_executor  # noqa: E402
from repro.core.modelzoo import make_model as jax_make_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.paper import AG_NEWS  # noqa: E402
from repro_torch.core import algorithms, executor  # noqa: E402
from repro_torch.core import distillation as D  # noqa: E402
from repro_torch.core import modelzoo  # noqa: E402
from repro_torch.data.synthetic import SyntheticTextTask  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from test_torch_baselines_batched import (  # noqa: E402
    TOL, fixture_data, max_diff, reference_init)
from test_torch_baselines_stateful import (  # noqa: E402
    reference_client_noise, reference_fedgen, reference_server_noise)
from torch_threads import one_torch_thread  # noqa: E402,F401

C = 10
T = bridge.params_from_numpy
TEXT_SMALL = dict(d_model=32, seq_len=16, vocab_size=200)


def perturbed(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + scale * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


def models(projection_head):
    jtask, _, task, _ = fixture_data()
    return (jax_make_model(jtask, projection_head=projection_head, width=8),
            modelzoo.make_model(task, projection_head=projection_head,
                                width=8))


def batch(n=8, client=3):
    data = fixture_data()[3]
    x, y = data.clients[client].x[:n], data.clients[client].y[:n]
    mask = np.ones(n, np.float32)
    mask[[3, 6]] = 0.0
    return x, y, mask


def torch_value_and_grad(loss, params_np, *args):
    params = T(params_np)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    value, _ = loss(params, *args)
    value.backward()
    return float(value.detach()), jax.tree_util.tree_map(
        lambda p: p.grad.numpy(), params)


def to_torch(tree):
    """numpy / jax leaves -> tensors; Python scalars and keys stay."""
    def conv(a):
        if isinstance(a, (np.ndarray, jax.Array)):
            return torch.from_numpy(np.array(a))
        return a
    return jax.tree_util.tree_map(conv, tree)


# ------------------------------------------------------- distillation

def test_param_distances_match_reference():
    rng = np.random.default_rng(0)
    a = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    b = perturbed(a, 1, 0.3)
    stacked = jax.tree_util.tree_map(
        lambda l: np.stack([l + i * 0.1 for i in range(3)]).astype(np.float32),
        a)
    assert abs(float(D.param_sq_dist(T(a), T(b)))
               - float(JD.param_sq_dist(a, b))) < TOL
    np.testing.assert_allclose(
        D.param_sq_dist_per_client(T(stacked), T(b)).numpy(),
        np.asarray(JD.param_sq_dist_per_client(stacked, b)), rtol=0, atol=TOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_kd_loss_mse_matches_reference(with_mask):
    rng = np.random.default_rng(2)
    t, s = (rng.standard_normal((8, C)).astype(np.float32) * 2
            for _ in range(2))
    mask = batch()[2] if with_mask else None
    got = D.kd_loss_mse(torch.from_numpy(t), torch.from_numpy(s), 0.4,
                        mask=None if mask is None else torch.from_numpy(mask))
    want = JD.kd_loss_mse(t, s, 0.4, mask=mask)
    assert abs(float(got) - float(want)) < TOL


@pytest.mark.parametrize("losses,lam,beta", [
    ([0.0], 0.1, None), ([2.3, 1.7, 2.9], 0.1, None),
    ([0.5, 0.5, 0.1, 3.0, 1.0], 0.2, None), ([1.2, 0.8], 0.1, 0.7)])
def test_vote_coefficients_match_reference(losses, lam, beta):
    got = D.vote_coefficients(losses, lam=lam, beta=beta)
    want = JD.vote_coefficients(losses, lam=lam, beta=beta)
    assert all(isinstance(g, float) for g in got)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert abs(sum(got) - 2 * lam) < 1e-6


# ------------------------------------------------------- loss_fn parity

def payloads(name, init, jalgo, algo):
    """(reference payload, port payload, reference state, port state) of one
    local step of ``name``, with non-trivial values everywhere."""
    rng = np.random.default_rng(11)
    small = lambda: jax.tree_util.tree_map(
        lambda a: (1e-2 * rng.standard_normal(a.shape)).astype(np.float32),
        init)
    if name in ("fedprox", "feddyn"):
        anchor = perturbed(init, 5)
        jp, st = {"anchor": anchor}, ()
        if name == "feddyn":
            st = {"h": small()}
        return jp, T(jp), st, to_torch(st)
    if name in ("fedgkd", "fedgkd-mse", "fedgkd+"):
        jp = {"teacher": perturbed(init, 5)}
        return jp, T(jp), (), ()
    if name == "fedgkd-vote":
        jm, m = models(False)
        jsrv = jalgo.init_server(init, jm, C)
        tsrv = algo.init_server(T(init), m, C)
        for i, seed in enumerate((5, 6)):
            jsrv["buffer"].push(perturbed(init, seed))
            tsrv["buffer"].push(T(perturbed(init, seed)))
        jsrv["val_losses"] = tsrv["val_losses"] = [2.1, 2.4, 2.2]
        return (jalgo.round_payload(jsrv, None), algo.round_payload(tsrv),
                (), ())
    if name == "moon":
        jp = {"global": perturbed(init, 5)}
        st = {"prev": perturbed(init, 6)}
        return jp, T(jp), st, T(st)
    if name == "feddistill+":
        table = rng.standard_normal((C, C)).astype(np.float32)
        jp = {"label_logits": table, "enable": np.float32(1.0)}
        return jp, to_torch(jp), (), ()
    if name == "scaffold":
        jp = {"c": small(), "anchor": perturbed(init, 5)}
        st = {"c_k": small()}
        return jp, T(jp), st, T(st)
    if name == "fedgen":
        jm, m = models(False)
        gen = reference_fedgen(jalgo, C, 32)
        dist = np.arange(1, C + 1, dtype=np.float32) / 55.0
        key = jax.random.split(jax.random.PRNGKey(0))[1]   # round 0's key
        jp = {"gen": gen, "label_dist": dist, "rng": key}
        tp = {"gen": T(gen), "label_dist": torch.from_numpy(dist), "round": 0}
        return jp, tp, (), ()
    return (), (), (), ()


SINGLE = ["fedavg", "fedprox", "fedgkd", "fedgkd-mse", "fedgkd+",
          "fedgkd-vote", "moon", "feddistill+", "scaffold", "feddyn", "fedgen"]


def make_pair(name):
    if name == "fedgkd-mse":
        return (jax_algorithms.make("fedgkd", loss_type="mse"),
                algorithms.make("fedgkd", loss_type="mse"))
    if name == "fedgkd-vote":
        return (jax_algorithms.make(name, buffer_m=3),
                algorithms.make(name, buffer_m=3))
    jalgo = jax_algorithms.make(name)
    if name == "fedgen":
        return jalgo, algorithms.make(
            name, client_noise=reference_client_noise(0, 32))
    return jalgo, algorithms.make(name)


# the algorithms with a precompute stage run their loss from ``aux`` too
WITH_AUX = ["fedgkd", "fedgkd-mse", "fedgkd+", "fedgkd-vote", "feddistill+"]


def cases(names):
    return ([pytest.param(n, False, id=f"{n}-inline") for n in names]
            + [pytest.param(n, True, id=f"{n}-aux") for n in names
               if n in WITH_AUX])


@pytest.mark.parametrize("name,use_aux", cases(SINGLE))
def test_loss_fn_value_and_grad_match_reference(name, use_aux):
    jalgo, algo = make_pair(name)
    init = reference_init(algo.needs_projection_head)
    jm, m = models(algo.needs_projection_head)
    jp, tp, js, ts = payloads(name, init, jalgo, algo)
    x, y, mask = batch()
    tx, ty, tmask = (torch.from_numpy(a) for a in (x, y, mask))
    jaux = taux = None
    if use_aux:
        jaux = jalgo.precompute_aux(jm, jp, x, y, mask)
        taux = algo.precompute_aux(m, tp, tx, ty, tmask)
        for k in jaux:
            np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                       rtol=0, atol=TOL)
    (jl, _), jg = jax.jit(jax.value_and_grad(jalgo.loss_fn(jm), has_aux=True))(
        init, jp, js, x, y, mask, jaux)
    tl, tg = torch_value_and_grad(algo.loss_fn(m), init, tp, ts, tx, ty,
                                  tmask, taux)
    assert abs(tl - float(jl)) < TOL
    assert max_diff(tg, jg) < TOL


BATCHED = ["fedavg", "fedprox", "fedgkd", "fedgkd-mse", "fedgkd+",
           "fedgkd-vote"]


@pytest.mark.parametrize("name,use_aux", cases(BATCHED))
def test_batched_loss_fn_matches_loss_fn_per_client(name, use_aux):
    jalgo, algo = make_pair(name)
    init = reference_init(algo.needs_projection_head)
    jm, m = models(algo.needs_projection_head)
    jp, tp, _, _ = payloads(name, init, jalgo, algo)
    k, b = 3, 5
    data = fixture_data()[3]
    x = np.stack([data.clients[i].x[:b] for i in range(k)])
    y = np.stack([data.clients[i].y[:b] for i in range(k)])
    mask = np.ones((k, b), np.float32)
    mask[1, 3:] = 0.0
    stacked = jax.tree_util.tree_map(
        lambda *xs: np.stack(xs),
        *[perturbed(init, 20 + i, 0.03) for i in range(k)])
    tx, ty, tmask = (torch.from_numpy(a) for a in (x, y, mask))
    taux = jaux = None
    if use_aux:
        flat = lambda a: a.reshape((k * b,) + a.shape[2:])
        taux = {key: v.reshape((k, b) + tuple(v.shape[1:]))
                for key, v in algo.precompute_aux(
                    m, tp, flat(tx), flat(ty), flat(tmask)).items()}
        jaux = {key: np.asarray(v).reshape((k, b) + v.shape[1:])
                for key, v in jalgo.precompute_aux(
                    jm, jp, flat(x), flat(y), flat(mask)).items()}
    total, per = algo.batched_loss_fn(m)(T(stacked), tp, (), tx, ty, tmask,
                                         taux)
    _, jper = jax.jit(jalgo.batched_loss_fn(jm))(stacked, jp, (), x, y, mask,
                                                 jaux)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper),
                               rtol=0, atol=TOL)
    assert abs(float(total) - float(per.sum())) < TOL
    loss = algo.loss_fn(m)
    for i in range(k):
        one = jax.tree_util.tree_map(lambda a: a[i], stacked)
        aux_i = None if taux is None else {key: v[i] for key, v in taux.items()}
        li, _ = loss(T(one), tp, (), tx[i], ty[i], tmask[i], aux_i)
        assert abs(float(li) - float(per[i])) < TOL


def test_client_stacked_projection_head_dense():
    """``layers.dense`` on the client-stacked route: a (K, F, O) weight with
    a (K, O) bias on a (K, B, F) activation is each client's own layer."""
    from repro_torch.models import layers
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((4, 6, 5)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 7, 6)).astype(np.float32))
    got = layers.dense({"w": w, "b": bias}, x)
    for i in range(4):
        torch.testing.assert_close(got[i], x[i] @ w[i] + bias[i], rtol=0,
                                   atol=TOL)


# ------------------------------------------------------- FedGKD-VOTE

def test_fedgkd_vote_payload_padding_matches_reference():
    jalgo = jax_algorithms.make("fedgkd-vote", buffer_m=4)
    algo = algorithms.make("fedgkd-vote", buffer_m=4)
    init = reference_init(False)
    jm, m = models(False)
    jsrv = jalgo.init_server(init, jm, C)
    tsrv = algo.init_server(T(init), m, C)
    jsrv["buffer"].push(perturbed(init, 7))
    tsrv["buffer"].push(T(perturbed(init, 7)))
    jsrv["val_losses"] = tsrv["val_losses"] = [2.0, 2.5]
    jp, tp = jalgo.round_payload(jsrv, None), algo.round_payload(tsrv)
    np.testing.assert_allclose(tp["gammas"].numpy(), np.asarray(jp["gammas"]),
                               rtol=0, atol=1e-7)
    assert tp["gammas"][2:].abs().sum() == 0          # padded slots: γ = 0
    np.testing.assert_array_equal(tp["teacher_versions"],
                                  jp["teacher_versions"])
    assert list(tp["teacher_versions"]) == [1, 0, 1, 1]
    assert max_diff(bridge.params_to_numpy(tp["teachers"]), jp["teachers"]) == 0
    # padding repeats the newest model
    newest = bridge.params_to_numpy(tsrv["buffer"].models[0])
    for slot in (2, 3):
        assert max_diff(jax.tree_util.tree_map(lambda a: a[slot],
                                               bridge.params_to_numpy(
                                                   tp["teachers"])),
                        newest) == 0
    keys, get_part = algo.precompute_parts(tp)
    assert keys == tuple(int(v) for v in jp["teacher_versions"])
    x = torch.from_numpy(batch()[0])
    parts = torch.stack([algo.precompute_part(m, get_part(i), x)
                         for i in range(len(keys))])
    combined = algo.precompute_combine(tp, parts, x, None, None)
    direct = algo.precompute_aux(m, tp, x, None, None)
    for key in ("tbar", "tent"):
        torch.testing.assert_close(combined[key], direct[key], rtol=0,
                                   atol=TOL)
    jdirect = jalgo.precompute_aux(jm, jp, np.asarray(x), None, None)
    for key in ("tbar", "tent"):
        np.testing.assert_allclose(direct[key].numpy(),
                                   np.asarray(jdirect[key]), rtol=0, atol=TOL)


def test_fedgkd_vote_refreshes_validation_losses():
    jalgo = jax_algorithms.make("fedgkd-vote", buffer_m=3)
    algo = algorithms.make("fedgkd-vote", buffer_m=3)
    init = reference_init(False)
    jm, m = models(False)
    data = fixture_data()[3]
    vx, vy = data.test_x[:16], data.test_y[:16]
    jsrv = jalgo.init_server(init, jm, C)
    tsrv = algo.init_server(T(init), m, C)
    ups = [perturbed(init, 30 + i) for i in range(2)]
    jsrv = jalgo.server_update(jsrv, [{"params": u} for u in ups], [3.0, 5.0],
                               jm, (vx, vy))
    tsrv = algo.server_update(tsrv, [{"params": T(u)} for u in ups],
                              [3.0, 5.0], m,
                              (torch.from_numpy(vx), torch.from_numpy(vy)))
    assert len(tsrv["val_losses"]) == 2
    np.testing.assert_allclose(tsrv["val_losses"], jsrv["val_losses"],
                               rtol=0, atol=TOL)
    tsrv = algo.server_update(tsrv, [{"params": T(u)} for u in ups],
                              [1.0, 1.0], m, None)
    assert tsrv["val_losses"] == [0.0, 0.0, 0.0]


# ------------------------------------------------------- MOON

def test_moon_all_zero_feature_row_has_finite_gradient():
    """A zero feature row (padding) through the rsqrt-with-eps cosine: the
    loss and every gradient stay finite, and match the reference's."""
    algo, jalgo = algorithms.make("moon"), jax_algorithms.make("moon")
    init = reference_init(True)
    zeroed = jax.tree_util.tree_map(np.copy, init)
    # the projection head's last layer at 0 makes every feature row 0
    zeroed["proj_head"]["fc2"]["w"][:] = 0.0
    zeroed["proj_head"]["fc2"]["b"][:] = 0.0
    jm, m = models(True)
    x, y, mask = batch()
    payload = {"global": perturbed(init, 5)}
    state = {"prev": perturbed(init, 6)}
    with torch.no_grad():
        z = m.features(T(zeroed), torch.from_numpy(x))
    assert float(z.abs().max()) == 0.0
    tl, tg = torch_value_and_grad(algo.loss_fn(m), zeroed, T(payload),
                                  T(state), torch.from_numpy(x),
                                  torch.from_numpy(y), torch.from_numpy(mask))
    assert np.isfinite(tl)
    assert all(np.isfinite(g).all() for g in jax.tree_util.tree_leaves(tg))
    (jl, _), jg = jax.jit(jax.value_and_grad(jalgo.loss_fn(jm), has_aux=True))(
        zeroed, payload, state, x, y, mask)
    assert abs(tl - float(jl)) < TOL
    # at z = 0 the cosine's gradient is the upstream one times
    # rsqrt(1e-12) = 1e6, so the head's gradients reach ~1e6: each leaf is
    # held to 1e-5 of its largest magnitude (it reaches 2.5e-7 of it)
    for g, w in zip(jax.tree_util.tree_leaves(tg),
                    jax.tree_util.tree_leaves(jg)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= TOL * max(np.abs(w).max(), 1.0)
    assert np.abs(tg["proj_head"]["fc2"]["w"]).max() > 1e5


# ------------------------------------------------------- FedDistill+

def test_feddistill_plus_finalize_and_server_update_match_reference():
    jalgo, algo = jax_algorithms.make("feddistill+"), algorithms.make(
        "feddistill+")
    init = reference_init(False)
    jm, m = models(False)
    data = fixture_data()[3]
    jsrv = jalgo.init_server(init, jm, C)
    tsrv = algo.init_server(T(init), m, C)
    assert float(tsrv["have_logits"]) == 0.0
    jups, tups = [], []
    for i, cid in enumerate((1, 4)):
        p = perturbed(init, 40 + i)
        cx, cy = data.clients[cid].x, data.clients[cid].y
        mask = np.ones(len(cy), np.float32)
        mask[-1] = 0.0
        je = jalgo.client_finalize(jm, p, cx, cy, mask, None)
        te = algo.client_finalize(m, T(p), torch.from_numpy(cx),
                                  torch.from_numpy(cy),
                                  torch.from_numpy(mask), None)
        for key in ("logit_sums", "label_counts"):
            np.testing.assert_allclose(te[key].numpy(), np.asarray(je[key]),
                                       rtol=0, atol=TOL)
        jups.append({"params": p, **je})
        tups.append({"params": T(p), **te})
    jsrv = jalgo.server_update(jsrv, jups, [4.0, 7.0], jm)
    tsrv = algo.server_update(tsrv, tups, [4.0, 7.0], m)
    np.testing.assert_allclose(tsrv["label_logits"].numpy(),
                               np.asarray(jsrv["label_logits"]), rtol=0,
                               atol=TOL)
    assert float(tsrv["have_logits"]) == 1.0
    assert max_diff(bridge.params_to_numpy(tsrv["global"]),
                    jsrv["global"]) < TOL


# ------------------------------------------------------- SCAFFOLD, FedDyn

@pytest.mark.parametrize("n_clients", [None, 2, 5, 20])
def test_scaffold_participation_fraction_matches_reference(n_clients):
    kw = dict(lr=0.01, local_steps_hint=3)
    jalgo, algo = jax_algorithms.make("scaffold", **kw), algorithms.make(
        "scaffold", **kw)
    init = reference_init(False)
    jm, m = models(False)
    jsrv = jalgo.init_server(init, jm, C)
    tsrv = algo.init_server(T(init), m, C)
    jsrv["c"] = perturbed(jax.tree_util.tree_map(np.zeros_like, init), 9, 0.1)
    tsrv["c"] = T(jsrv["c"])
    ups = [perturbed(init, 50 + i, 0.01) for i in range(2)]
    jsrv = jalgo.server_update(jsrv, [{"params": u} for u in ups], [1.0, 3.0],
                               jm, n_clients=n_clients)
    tsrv = algo.server_update(tsrv, [{"params": T(u)} for u in ups],
                              [1.0, 3.0], m, n_clients=n_clients)
    assert max_diff(bridge.params_to_numpy(tsrv["c"]), jsrv["c"]) < TOL
    assert max_diff(bridge.params_to_numpy(tsrv["global"]),
                    jsrv["global"]) < TOL


def test_feddyn_dual_update_matches_reference():
    jalgo, algo = jax_algorithms.make("feddyn"), algorithms.make("feddyn")
    init = reference_init(False)
    state = {"h": perturbed(jax.tree_util.tree_map(np.zeros_like, init), 3,
                            0.01)}
    params = perturbed(init, 4)
    payload = {"anchor": init}
    want = jalgo.update_client_state(state, params, payload)
    got = algo.update_client_state(T(state), T(params), T(payload))
    assert max_diff(bridge.params_to_numpy(got["h"]), want["h"]) < TOL
    assert algo.init_client_state(0, T(init))["h"]["fc"]["w"].abs().sum() == 0


# ------------------------------------------------------- FedGen

def test_fedgen_server_step_matches_reference_with_its_draws():
    jalgo = jax_algorithms.make("fedgen", gen_steps=5)
    algo = algorithms.make("fedgen", gen_steps=5,
                           server_noise=reference_server_noise(C, 32))
    init = reference_init(False)
    jm, m = models(False)
    x = fixture_data()[3].clients[0].x[:2]
    jsrv = jalgo.init_server_with_probe(init, jm, C, x)
    algo._gen_init = lambda g, c, f: T(reference_fedgen(jalgo, c, f))
    tsrv = algo.init_server_with_probe(T(init), m, C, torch.from_numpy(x))
    assert max_diff(bridge.params_to_numpy(tsrv["gen"]), jsrv["gen"]) == 0
    with pytest.raises(TypeError, match="probe"):
        algo.init_server(T(init), m, C)
    data = fixture_data()[3]
    jups, tups = [], []
    for i, cid in enumerate((0, 2, 5)):
        p = perturbed(init, 60 + i)
        cy = data.clients[cid].y
        mask = np.ones(len(cy), np.float32)
        je = jalgo.client_finalize(jm, p, data.clients[cid].x, cy, mask,
                                   {"label_dist": jsrv["label_dist"]})
        te = algo.client_finalize(m, T(p), None, torch.from_numpy(cy),
                                  torch.from_numpy(mask),
                                  {"label_dist": tsrv["label_dist"]})
        np.testing.assert_array_equal(te["label_counts"].numpy(),
                                      np.asarray(je["label_counts"]))
        jups.append({"params": p, **je})
        tups.append({"params": T(p), **te})
    jsrv = jalgo.server_update(jsrv, jups, [1.0, 1.0, 1.0], jm)
    tsrv = algo.server_update(tsrv, tups, [1.0, 1.0, 1.0], m)
    np.testing.assert_allclose(tsrv["label_dist"].numpy(),
                               np.asarray(jsrv["label_dist"]), rtol=0,
                               atol=1e-7)
    assert max_diff(bridge.params_to_numpy(tsrv["gen"]), jsrv["gen"]) < TOL


def test_fedgen_default_noise_is_device_independent_and_seeded():
    algo = algorithms.make("fedgen")
    payload = {"label_dist": torch.tensor([0.0, 0.25, 0.75]), "round": 3}
    client_noise, server_noise = algo.noise_sources(10)
    y1, z1 = client_noise(payload, torch.tensor([1, 2, 2]), 16)
    y2, z2 = client_noise(payload, torch.tensor([2, 2, 1]), 16)
    assert torch.equal(y1, y2) and torch.equal(z1, z2)   # same label sum
    assert set(y1.tolist()) <= {1, 2} and z1.shape == (16, 32)
    y3, _ = client_noise(dict(payload, round=4), torch.tensor([1]), 16)
    _, z3 = client_noise(dict(payload, round=4), torch.tensor([1]), 16)
    assert not torch.equal(z1, z3)
    ys, zs = server_noise(1, 0)
    assert ys.shape == (64,) and zs.shape == (64, 32) and int(ys.max()) < 10
    assert not torch.equal(zs, server_noise(1, 1)[1])
    # what the constructor is given replaces the default
    mine = (lambda p, lab, b: "client"), (lambda rnd, i: "server")
    assert algorithms.make("fedgen", client_noise=mine[0],
                           server_noise=mine[1]).noise_sources(10) == mine


# ------------------------------------------------------- models

def test_projection_head_resnet8_matches_reference():
    init = reference_init(True)
    jm, m = models(True)
    assert m.has_projection_head and not models(False)[1].has_projection_head
    assert init["proj_head"]["fc1"]["w"].shape == (32, 32)
    assert init["proj_head"]["fc2"]["w"].shape == (32, 256)
    assert init["fc"]["w"].shape == (256, C)
    mine = m.init(torch.Generator().manual_seed(0))
    assert ([tuple(t.shape) for t in tree_leaves(mine)]
            == [a.shape for a in jax.tree_util.tree_leaves(init)])
    x = batch()[0]
    with torch.no_grad():
        logits = m.apply(T(init), torch.from_numpy(x))
        feats = m.features(T(init), torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(
        jax.jit(jm.apply)(init, x)), rtol=0, atol=TOL)
    np.testing.assert_allclose(feats.numpy(), np.asarray(
        jax.jit(jm.features)(init, x)), rtol=0, atol=TOL)
    assert feats.shape == (8, 256)


def test_projection_head_text_classifier_matches_reference():
    jtask = dataclasses.replace(JAX_AG_NEWS, **TEXT_SMALL)
    task = dataclasses.replace(AG_NEWS, **TEXT_SMALL)
    jm = jax_make_model(jtask, projection_head=True)
    m = modelzoo.make_model(task, projection_head=True)
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.jit(jm.init)(jax.random.PRNGKey(2)))
    assert init["proj_head"]["fc2"]["w"].shape == (32, 256)
    mine = m.init(torch.Generator().manual_seed(0))
    assert ([tuple(t.shape) for t in tree_leaves(mine)]
            == [a.shape for a in jax.tree_util.tree_leaves(init)])
    x, _ = SyntheticTextTask(4, vocab_size=200, seq_len=16).generate(6, 1)
    with torch.no_grad():
        logits = m.apply(T(init), torch.from_numpy(x))
        feats = m.features(T(init), torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(
        jax.jit(jm.apply)(init, x)), rtol=0, atol=TOL)
    np.testing.assert_allclose(feats.numpy(), np.asarray(
        jax.jit(jm.features)(init, x)), rtol=0, atol=TOL)


# ------------------------------------------------------- registry, routes

def test_available_matches_reference_and_make_builds_each():
    assert algorithms.available() == jax_algorithms.available()
    assert len(algorithms.available()) == 10
    for name in algorithms.available():
        algo, jalgo = algorithms.make(name), jax_algorithms.make(name)
        assert algo.name == jalgo.name == name
        assert algo.needs_projection_head == jalgo.needs_projection_head
        assert algo.comm_multiplier == jalgo.comm_multiplier
        assert algo.hp == jalgo.hp
    with pytest.raises(ValueError, match="available"):
        algorithms.make("fedsomething")


@pytest.mark.parametrize("model_name", ["resnet8", "distilbert"])
@pytest.mark.parametrize("n_sample", [1, 4])
def test_auto_executor_matches_reference(model_name, n_sample):
    jtask, task = fixture_data()[0], fixture_data()[2]
    if model_name == "distilbert":
        jtask = dataclasses.replace(JAX_AG_NEWS, **TEXT_SMALL)
        task = dataclasses.replace(AG_NEWS, **TEXT_SMALL)
    routes = {}
    for name in algorithms.available():
        algo, jalgo = algorithms.make(name), jax_algorithms.make(name)
        head = algo.needs_projection_head
        jm = jax_make_model(jtask, projection_head=head, width=8)
        m = modelzoo.make_model(task, projection_head=head, width=8)
        got = executor.get_executor("auto", algo, n_sample, m).name
        assert got == jax_executor.get_executor("auto", jalgo, n_sample,
                                                jm).name
        routes[name] = got
    batched = {"fedavg", "fedprox", "fedgkd", "fedgkd-vote", "fedgkd+"}
    want = {name: ("vmap" if model_name == "resnet8" and n_sample > 1
                   and name in batched else "sequential")
            for name in routes}
    assert routes == want


def test_vmap_executor_refuses_the_client_hooks():
    """The vmap executor no longer refuses the five algorithms with client
    hooks: with no client-stacked loss they take the vmapped round body,
    and ``client_finalize`` / ``update_client_state`` run as
    ``torch.func.vmap`` over the stacked params.  A round of 2 clients
    (every batch full, so FedGen draws at one batch size on both routes)
    equals the sequential executor's: uploads, states and losses."""
    data = fixture_data()[3]
    clients = [data.clients[i] for i in (1, 2)]            # 9 and 12 rows
    for name in ("moon", "feddistill+", "fedgen", "feddyn", "scaffold"):
        algo = algorithms.make(name)
        m = models(algo.needs_projection_head)[1]
        init = T(reference_init(algo.needs_projection_head))
        srv = (algo.init_server_with_probe(init, m, C,
                                           torch.from_numpy(clients[0].x[:2]))
               if name == "fedgen" else algo.init_server(init, m, C))
        payload = algo.round_payload(srv)
        states = [algo.init_client_state(k, init) for k in (1, 2)]
        out = {}
        for exec_ in (executor.VmapExecutor(), executor.SequentialExecutor()):
            ctx = executor.RoundContext(algo=algo, model=m, opt=sgd(), lr=0.1,
                                        batch_size=8, epochs=1,
                                        device=torch.device("cpu"))
            assert ctx.batched_local_update is None
            # every one has a client hook; SCAFFOLD's state update is the
            # reference's identity (c_k moves in server_update), which
            # marks its state mutable for the population tier
            assert ctx.has_finalize or ctx.has_state_update
            out[exec_.name] = exec_.run_round(
                ctx, init, payload, states, clients, np.random.default_rng(0),
                client_ids=[1, 2])
            if exec_.name == "vmap":
                assert ctx.telemetry["round_body"] == "vmap"
        v, s_ = out["vmap"], out["sequential"]
        np.testing.assert_allclose(v.local_losses, s_.local_losses, rtol=0,
                                   atol=TOL)
        assert max_diff(bridge.params_to_numpy(v.uploads),
                        bridge.params_to_numpy(s_.uploads)) < TOL
        if name in ("moon", "feddyn"):
            assert max_diff(bridge.params_to_numpy(v.client_states),
                            bridge.params_to_numpy(s_.client_states)) < TOL
        if name == "scaffold":
            for res in (v, s_):
                assert max_diff(bridge.params_to_numpy(res.client_states),
                                bridge.params_to_numpy(states)) == 0
    ctx = executor.RoundContext(algo=algorithms.make("fedgkd"),
                                model=models(False)[1], opt=sgd(), lr=0.1,
                                batch_size=8, epochs=1,
                                device=torch.device("cpu"))
    assert not (ctx.has_finalize or ctx.has_state_update)


def test_sequential_executor_runs_the_client_hooks():
    """One FedDyn + FedDistill+ round through the sequential executor: the
    new client states are the dual update of the trained params, and the
    uploads carry FedDistill+'s logit table over the client's whole shard."""
    init = reference_init(False)
    m = models(False)[1]
    data = fixture_data()[3]
    clients = [data.clients[i] for i in (0, 3)]
    for name in ("feddyn", "feddistill+"):
        algo = algorithms.make(name)
        srv = algo.init_server(T(init), m, C)
        ctx = executor.RoundContext(algo=algo, model=m, opt=sgd(), lr=0.1,
                                    batch_size=8, epochs=1,
                                    device=torch.device("cpu"))
        states = [algo.init_client_state(k, srv["global"]) for k in (0, 3)]
        payload = algo.round_payload(srv)
        res = executor.SequentialExecutor().run_round(
            ctx, srv["global"], payload, states, clients,
            np.random.default_rng(0), client_ids=[0, 3])
        for up, st, cd in zip(res.uploads, res.client_states, clients):
            if name == "feddyn":
                zero = algo.init_client_state(0, srv["global"])
                want = algo.update_client_state(zero, up["params"], payload)
                assert max_diff(bridge.params_to_numpy(st["h"]),
                                bridge.params_to_numpy(want["h"])) == 0
                assert float(st["h"]["fc"]["w"].abs().max()) > 0
            else:
                assert float(up["label_counts"].sum()) == cd.n
                assert up["logit_sums"].shape == (C, C)


def test_comm_multipliers_match_reference():
    for kw in (dict(buffer_m=1), dict(buffer_m=5)):
        for name in ("fedgkd", "fedgkd-vote", "fedgkd+"):
            assert (algorithms.make(name, **kw).comm_multiplier
                    == jax_algorithms.make(name, **kw).comm_multiplier)

