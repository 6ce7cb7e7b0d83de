"""The frozen yardstick held to fixed numbers (not to the port's live
code): model FLOPs, parameter counts, conv and attention costs, the data
generators and the weights drawn from a seed."""
import numpy as np
import pytest
import torch

import cells  # noqa: F401  (puts the checkout on the path)
from cardbench.frozen import data, layouts
from cardbench.frozen import roofline as rl

PHI16 = dict(d_model=3072, n_layers=16, n_heads=24, n_kv_heads=8,
             head_dim=128, d_ff=8192, vocab=200064)


def test_phi4_mini_params_and_step_flops():
    n = rl.dense_lm_params(**PHI16)
    assert n == 2_225_310_720
    # one FedGKD step of 4 x 1,024 tokens with its teacher forward
    assert rl.lm_model_flops(n, 4 * 1024, "train", True) == 72_918_981_672_960
    assert rl.lm_model_flops(n, 8 * 1024, "forward") == 36_459_490_836_480


def test_attention_cost_at_the_phi4_mini_step():
    nbytes, flops = rl.attention_fwd_cost(2, 1024, 1024, 24, 8, 128, True, 2)
    assert nbytes == 33_554_432
    assert flops == 12_897_484_800
    assert rl.attended_pairs(1024, 1024, True) == 524_800
    assert rl.attended_pairs(3, 5, True) == 3 + 4 + 5
    bound = rl.attention_fwd_bound_s(4, 1024, 1024, 24, 8, 128, True,
                                     "bfloat16")
    assert bound == pytest.approx(2.6081870171890797e-05, rel=1e-12)


def test_resnet8_geometry_and_costs():
    assert rl.same_pads(32, 3, 2) == (16, 0, 1)
    assert rl.same_pads(32, 1, 2) == (16, 0, 0)
    assert rl.taps_in_bounds(32, 3, 1) == 94
    assert len(rl.resnet8_convs(16)) == 9
    assert rl.resnet8_forward_flops(16, 10) == 23_149_184
    assert rl.resnet8_dw_bound_s(4, 64, 16) == pytest.approx(
        5.639481313432836e-05, rel=1e-12)


def test_lm_token_batches_fixed():
    toks = data.lm_token_batches(np.random.default_rng(7), 2, 6, 200064)
    assert toks.dtype == np.int32
    assert toks.tolist() == [[23755, 173070, 101355, 135271, 56382, 58418],
                             [114448, 164298, 12252, 14942, 89150, 127932]]
    ev = data.eval_tokens(503, 9)
    assert ev.shape == (8, 9) and int(ev.sum()) == 20_252


def test_client_picks_and_cohort_fixed():
    rng = np.random.default_rng(3)
    assert data.cohort(rng, 20, 4).tolist() == [4, 1, 3, 13]
    picks = data.client_picks(rng, 10, 4, 1, max_batches=2)
    assert picks.tolist() == [[6, 8, 4, 1], [5, 2, 3, 7]]
    wrapped = data.client_picks(np.random.default_rng(0), 5, 4, 1)
    assert wrapped.shape == (2, 4) and len(set(wrapped[1])) == 4


def test_dirichlet_partition_is_the_sources():
    """The paper's split of 45,000 uniform labels over 20 clients at
    α = 0.5 and seed 0, as the cell runs it: fixed sizes, a disjoint
    cover, every client at least 20 batches of 64."""
    y = np.random.default_rng(0).integers(0, 10, size=45000)
    parts = data.dirichlet_partition(y, 20, 0.5, 0)
    sizes = sorted(len(p) for p in parts)
    assert sizes[:3] == [1413, 1505, 1541] and sizes[-1] == 4152
    assert np.array_equal(np.sort(np.concatenate(parts)), np.arange(45000))
    assert data.client_steps(sizes[0], 64, 1, 20) == 20
    assert data.client_steps(100, 64, 1, 20) == 2
    assert data.client_steps(10, 64, 3) == 3


def test_federated_images_unequal_shards_and_seeded():
    kw = dict(n_clients=3, train_size=120, partition_seed=4, n_test=10,
              classes=10, hw=8, channels=3, alpha=0.5, device="cpu")
    a = data.federated_images(5, **kw)
    b = data.federated_images(5, **kw)
    sizes = [len(y) for _, y in a["clients"]]
    assert sum(sizes) == 120 and len(set(sizes)) > 1
    assert a["label_matrix"].sum(1).tolist() == sizes
    assert a["test_x"].shape == (10, 8, 8, 3)
    for (xa, ya), (xb, yb) in zip(a["clients"], b["clients"]):
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    c = data.federated_images(6, **kw)
    # the seed moves the images, not the shards
    assert [len(y) for _, y in c["clients"]] == sizes
    assert not np.array_equal(a["clients"][0][0], c["clients"][0][0])


def test_weights_drawn_from_the_seed():
    layout = layouts.dense_lm_layout(16, 2, 4, 2, 4, 32, 50, "bfloat16")
    w = layouts.draw(layout, 11, "cpu")
    again = layouts.draw_leaf(layout, 11, ("seg0", "mlp", "up", "w"), "cpu")
    assert torch.equal(w["seg0"]["mlp"]["up"]["w"], again)
    assert w["seg0"]["mlp"]["up"]["w"].dtype == torch.bfloat16
    assert w["seg0"]["mlp"]["up"]["w"].shape == (2, 16, 32)
    assert torch.equal(w["final_norm"]["scale"], torch.ones(16,
                                                            dtype=torch.bfloat16))
    std = w["seg0"]["mlp"]["down"]["w"].float().std().item()
    assert std == pytest.approx(1 / 32 ** 0.5, rel=0.2)
    other = layouts.draw(layout, 12, "cpu")
    assert not torch.equal(w["embed"]["table"], other["embed"]["table"])
    r8 = layouts.resnet8_layout(16, 10)
    assert len(layouts.paths(r8)) == 25
    assert layouts.leaf_seed(2 ** 40, 3) < 2 ** 63
