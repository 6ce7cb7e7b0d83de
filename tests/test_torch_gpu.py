"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA card; this file
imports no JAX, so it runs on the card's host as it is:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

The plain versions are the fp32 references, so TF32 is switched off for
each test.  Tolerance: 1e-5 of the plain version's largest magnitude, and
of no less than 1 (fp32, different summation orders): with one class the
KL is exactly 0 in the plain version, while the kernel forms it as a
difference of O(|logit|) terms and keeps a rounding residue of ~1e-7.
The SSD scan at the LM path's width is held to that, or, where the fp32
plain version is itself further than that from the float64 result (its
in-chunk decays reach ~-2000, and it forms them as differences of fp32
cumsums), to being no further from float64 than the plain version is; so
is the conv's weight gradient (both by ``_close_or_nearer``), whose plain
version sums up to 65,536 terms a client in one fp32 chain (cuBLAS does not
split them) and lands ~1.5e-5 of max|plain| from float64 at ResNet-8's stem.

The kernels' bf16 forms read bf16 and compute in fp32: their fp32 outputs
(B1's kl and logsumexps, B6) are held to the plain version on the same
values upcast at the fp32 bar above; their bf16 outputs (B4's o, B2's
dls, B5's y through its casting wrapper) to one bf16 ulp of the plain
version's output rounded to bf16, plus the fp32 bar (a kernel's fp32
value may sit across a rounding boundary from the plain version's by its
fp32 error); B4 also to the bf16 plain version, which rounds P to bf16
before P·V as the reference's attention does, at the reference's 2e-2.
A bf16 model's decode and forward are held to a forward in fp32 from the
same weights upcast: the decode no further from it than twice the bf16
forward is, or one bf16 ulp of its magnitude.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import algorithms, fl_loop  # noqa: E402
from repro_torch.configs.paper import AG_NEWS, CIFAR10, scaled  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.grouped_conv import ops as conv_ops  # noqa: E402
from repro_torch.kernels.grouped_conv import ref as conv_ref  # noqa: E402
from repro_torch.kernels.kd_kl import ops as kd_ops  # noqa: E402
from repro_torch.kernels.kd_kl import ref as kd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.models.resnet import resnet50_convs  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = 1e-5

# (K, N, H, Cin, Cout, k, stride): ResNet-8's convs at width 16 and K=4,
# K=1 eval and teacher-chunk shapes, an odd input size, Cout past the
# kernel's 64-channel tile, a ragged pixel tile (7x7 outputs, two images to
# a tile, N odd), ResNet-50's 7x7 stride-2 stem and a 1x1 conv over 2,048
# input channels (64 Cin chunks)
CONVS = [(4, 64, 32, 3, 16, 3, 1), (4, 64, 32, 16, 16, 3, 1),
         (4, 64, 32, 16, 32, 3, 2), (4, 64, 16, 32, 32, 3, 1),
         (4, 64, 32, 16, 32, 1, 2), (4, 64, 16, 32, 64, 3, 2),
         (4, 64, 8, 64, 64, 3, 1), (4, 64, 16, 32, 64, 1, 2),
         (1, 256, 32, 3, 16, 3, 1), (2, 3, 9, 4, 8, 3, 2),
         (1, 1024, 32, 16, 16, 3, 1), (1, 788, 8, 64, 64, 3, 1),
         (2, 4, 16, 32, 128, 3, 1), (3, 5, 7, 8, 24, 3, 1),
         (1, 2, 64, 3, 64, 7, 2), (1, 2, 8, 2048, 96, 1, 1)]


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=TOL * max(1.0, float(want.abs().max())))


def _close_or_nearer(got, plain, exact):
    """``_close`` to the fp32 plain version, or no further from the float64
    result ``exact`` than that version is."""
    err = float((got - plain).abs().max())
    if err <= TOL * max(1.0, float(plain.abs().max())):
        return
    e_got, e_plain = (float((t.double() - exact).abs().max())
                      for t in (got, plain))
    assert e_got <= e_plain, (
        f"{err:.3e} from the plain version and {e_got:.3e} from float64, "
        f"where the plain version is {e_plain:.3e} from it")


@pytest.mark.parametrize("t,v", [(256, 10), (256, 100), (256, 200),
                                 (1000, 37), (3, 1)])
@pytest.mark.parametrize("temp", [1.0, 2.0])
def test_kd_kl_kernels_match_plain(cuda, t, v, temp):
    gen = torch.Generator(device=cuda).manual_seed(t + v)
    lt, ls = (torch.randn(t, v, device=cuda, generator=gen) * 2
              for _ in range(2))
    g = torch.randn(t, device=cuda, generator=gen)
    kl, lse_t, lse_s = kd_ops.kd_kl_fwd(lt, ls, temp)
    torch.cuda.synchronize()
    for got, want in zip((kl, lse_t, lse_s), kd_ref.kd_kl_fwd_ref(lt, ls, temp)):
        _close(got, want)
    _close(kd_ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, temp),
           kd_ref.kd_kl_bwd_ref(lt, ls, lse_t, lse_s, g, temp))


def test_kd_kl_autograd_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    lt = torch.randn(4, 64, 10, device=cuda, generator=gen)
    ls = torch.randn(4, 64, 10, device=cuda, generator=gen).requires_grad_(True)
    before = dict(LAUNCHES)
    kd_ops.kd_kl_loss(lt, ls, 1.0).sum().backward()
    assert LAUNCHES["kd_kl_fwd"] == before["kd_kl_fwd"] + 1
    assert LAUNCHES["kd_kl_bwd"] == before["kd_kl_bwd"] + 1
    ls_cpu = ls.detach().cpu().requires_grad_(True)
    kd_ops.kd_kl_loss(lt.cpu(), ls_cpu, 1.0).sum().backward()
    _close(ls.grad.cpu(), ls_cpu.grad)


@pytest.mark.parametrize("case", CONVS, ids=str)
def test_grouped_conv_kernel_matches_plain(cuda, case):
    k, n, h, cin, cout, kk, s = case
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    x = torch.randn(k, n, h, h, cin, device=cuda, generator=gen)
    w = torch.randn(k, kk, kk, cin, cout, device=cuda,
                    generator=gen) / math.sqrt(kk * kk * cin)
    before = LAUNCHES["grouped_conv_fwd"]
    got = conv_ops.grouped_conv_fwd(x, w, s, "SAME")
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_conv_fwd"] == before + 1
    _close(got, conv_ref.grouped_conv_ref(x, w, s, "SAME"))


# ResNet-50's 23 distinct conv shapes at 64x64 inputs (H, Cin, Cout, k,
# stride), each at the local step's K=4, N=64
R50_CONVS = sorted({tuple(c[1:]) for c in resnet50_convs(64)})


@pytest.mark.parametrize("shape", R50_CONVS, ids=str)
def test_grouped_conv_kernel_at_resnet50_shapes(cuda, shape):
    h, cin, cout, kk, s = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(4, 64, h, h, cin, device=cuda, generator=gen)
    w = torch.randn(4, kk, kk, cin, cout, device=cuda,
                    generator=gen) / math.sqrt(kk * kk * cin)
    before = LAUNCHES["grouped_conv_fwd"]
    got = conv_ops.grouped_conv_fwd(x, w, s, "SAME")
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_conv_fwd"] == before + 1
    _close(got, conv_ref.grouped_conv_ref(x, w, s, "SAME"))


def test_kd_kl_under_vmap_of_grad(cuda):
    """B1/B2 under ``torch.func.vmap`` of ``grad`` over 8 clients: one
    launch each for all of them, against the plain versions."""
    from torch.func import grad, vmap

    gen = torch.Generator(device=cuda).manual_seed(11)
    lt, ls = (torch.randn(8, 32, 10, device=cuda, generator=gen) * 2
              for _ in range(2))
    g = torch.randn(8, 32, device=cuda, generator=gen)
    before = dict(LAUNCHES)
    dls = vmap(grad(lambda b, a, w: torch.sum(kd_ops.kd_kl_loss(a, b) * w)))(
        ls, lt, g)
    torch.cuda.synchronize()
    assert LAUNCHES["kd_kl_fwd"] == before["kd_kl_fwd"] + 1
    assert LAUNCHES["kd_kl_bwd"] == before["kd_kl_bwd"] + 1
    flat = [t.reshape(-1, 10) for t in (lt, ls)]
    _, lse_t, lse_s = kd_ref.kd_kl_fwd_ref(*flat, 1.0)
    _close(dls.reshape(-1, 10),
           kd_ref.kd_kl_bwd_ref(*flat, lse_t, lse_s, g.reshape(-1), 1.0))


@pytest.mark.parametrize("shape", [(16, 32, 64, 3, 2), (4, 1024, 256, 1, 1)],
                         ids=str)
def test_grouped_conv_under_vmap_of_grad(cuda, shape):
    """B3 under ``torch.func.vmap`` of ``grad`` of a single-client conv over
    K=4 clients: the rules fold the vmapped axis into K (one launch of the
    forward, one of the weight gradient), and the output and both
    gradients agree with the plain versions."""
    from torch.func import grad, vmap

    h, cin, cout, kk, s = shape
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(4, 16, h, h, cin, device=cuda, generator=gen)
    w = torch.randn(4, kk, kk, cin, cout, device=cuda,
                    generator=gen) / math.sqrt(kk * kk * cin)
    oh = conv_ref.same_pads(h, kk, s)[0]
    dy = torch.randn(4, 16, oh, oh, cout, device=cuda, generator=gen)

    def one(xi, wi, dyi):
        return torch.sum(conv_ops.client_batched_conv(
            xi[None], wi[None], stride=s)[0] * dyi)

    before = dict(LAUNCHES)
    dx, dw = vmap(grad(one, argnums=(0, 1)))(x, w, dy)
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_conv_fwd"] == before["grouped_conv_fwd"] + 1
    assert LAUNCHES["grouped_conv_dw"] == before["grouped_conv_dw"] + 1
    _close(dx, conv_ref.grouped_conv_dx(dy, w, s, h, h, "SAME"))
    _close(dw, conv_ref.shift_gemm_dw(x, dy, s, kk, kk, "SAME"))


@pytest.mark.parametrize("case", [(2, 3, 11, 4, 4, 3, 2),
                                  (3, 5, 9, 8, 24, 3, 1),
                                  (1, 2, 64, 3, 64, 7, 2)], ids=str)
def test_grouped_conv_kernel_valid_padding(cuda, case):
    """VALID: no pads, a stride that does not divide the input."""
    k, n, h, cin, cout, kk, s = case
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    x = torch.randn(k, n, h, h, cin, device=cuda, generator=gen)
    w = torch.randn(k, kk, kk, cin, cout, device=cuda, generator=gen)
    got = conv_ops.grouped_conv_fwd(x, w, s, "VALID")
    torch.cuda.synchronize()
    _close(got, conv_ref.grouped_conv_ref(x, w, s, "VALID"))


# ResNet-8's 9 convs at width 16 (H, Cin, Cout, k, stride) at the wave
# sizes the async loop and the fault-tolerant round add: K = 2 (a refill of
# B = 2) and K = 3 (a retried subset), N = 64
RESNET8_CONVS = [(32, 3, 16, 3, 1), (32, 16, 16, 3, 1), (32, 16, 32, 3, 2),
                 (16, 32, 32, 3, 1), (32, 16, 32, 1, 2), (16, 32, 64, 3, 2),
                 (8, 64, 64, 3, 1), (16, 32, 64, 1, 2)]


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("shape", RESNET8_CONVS, ids=str)
def test_grouped_conv_kernel_at_wave_sizes(cuda, k, shape):
    h, cin, cout, kk, s = shape
    gen = torch.Generator(device=cuda).manual_seed(k + sum(shape))
    x = torch.randn(k, 64, h, h, cin, device=cuda, generator=gen)
    w = torch.randn(k, kk, kk, cin, cout, device=cuda,
                    generator=gen) / math.sqrt(kk * kk * cin)
    before = LAUNCHES["grouped_conv_fwd"]
    got = conv_ops.grouped_conv_fwd(x, w, s, "SAME")
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_conv_fwd"] == before + 1
    _close(got, conv_ref.grouped_conv_ref(x, w, s, "SAME"))


# (K, N, H, Cin, Cout, k, stride, padding) for the weight-gradient kernel:
# ResNet-8's convs at every cohort size the port trains (K = 1-4, N = 64;
# the stem's Cin = 3 among them), ResNet-50's distinct shapes at the local
# step's K=4, N=64 (its 7x7 stride-2 stem, Cin = 3), VALID with strides that
# do not divide, Cout and Cin past a tile and a chunk, 1x1 chunks past 32
# channels (one of 256 and a partial 4, odd Cout) and a 3x3 tile of fewer
# images
CONV_DW = ([(k, 64) + g + ("SAME",) for k in (1, 2, 3, 4)
            for g in RESNET8_CONVS]
           + [(4, 64) + g + ("SAME",) for g in R50_CONVS]
           + [(2, 3, 11, 4, 4, 3, 2, "VALID"), (3, 5, 9, 8, 24, 3, 1, "VALID"),
              (1, 2, 64, 3, 64, 7, 2, "VALID"), (2, 4, 16, 40, 100, 3, 1, "SAME"),
              (3, 5, 7, 8, 24, 3, 1, "SAME"),
              (1, 8, 7, 260, 40, 1, 2, "SAME"), (2, 2, 9, 72, 33, 1, 1, "SAME"),
              (1, 40, 4, 64, 32, 3, 2, "SAME")])


@pytest.mark.parametrize("case", CONV_DW, ids=str)
def test_grouped_conv_dw_kernel_matches_plain(cuda, case):
    """The weight-gradient kernel against ``shift_gemm_dw`` (the per-tap
    fp32 bmm): one launch a call, and the same bits on every call (the
    splits' partials are summed in a fixed order)."""
    k, n, h, cin, cout, kk, s, pad = case
    gen = torch.Generator(device=cuda).manual_seed(sum(case[:7]))
    oh = conv_ref.resolve_pads(h, kk, s, pad)[0]
    x = torch.randn(k, n, h, h, cin, device=cuda, generator=gen)
    dy = torch.randn(k, n, oh, oh, cout, device=cuda, generator=gen)
    before = LAUNCHES["grouped_conv_dw"]
    got = conv_ops.grouped_conv_dw(x, dy, s, kk, kk, pad)
    again = conv_ops.grouped_conv_dw(x, dy, s, kk, kk, pad)
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_conv_dw"] == before + 2
    assert torch.equal(got, again)
    _close_or_nearer(got, conv_ref.shift_gemm_dw(x, dy, s, kk, kk, pad),
                     conv_ref.shift_gemm_dw(x.double(), dy.double(), s, kk, kk,
                                            pad))


def test_dp_noise_is_the_same_on_card_and_cpu(cuda):
    """DP's default noise is drawn on the CPU and moved: the card adds the
    CPU's draws, bit for bit."""
    from repro_torch.core import privacy

    params = {"w": torch.zeros(64, 33), "b": torch.ones(7)}
    dp = privacy.DPConfig(clip_norm=1.0, noise_multiplier=0.5, seed=4)
    on_cpu = privacy.noise_aggregate(params, dp, 4, 2)
    on_card = privacy.noise_aggregate(
        {k: v.to(cuda) for k, v in params.items()}, dp, 4, 2)
    for k in params:
        assert on_card[k].device.type == "cuda"
        assert torch.equal(on_card[k].cpu(), on_cpu[k])


def test_deferred_wave_returns_device_losses(cuda):
    """A deferred vmap wave leaves its per-client losses on the card, one
    (K,) tensor, equal to the undeferred wave's host floats."""
    import numpy as np

    from repro_torch.core import executor, modelzoo
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_map

    task = scaled(CIFAR10, 0.02, rounds=1, local_epochs=1)
    data = fl_loop.make_federated_data(task, alpha=0.5, seed=0, n_test=64)
    algo = algorithms.make("fedgkd")
    model = modelzoo.make_model(task, width=16)
    gp = tree_map(lambda t: t.to(cuda),
                  model.init(torch.Generator().manual_seed(0)))
    srv = algo.init_server(gp, model, task.num_classes)
    out = []
    for deferred in (True, False):
        ctx = executor.RoundContext(
            algo=algo, model=model, opt=sgd(), lr=0.05,
            batch_size=task.batch_size, epochs=1, device=cuda, max_batches=2,
            deferred=deferred)
        out.append(executor.VmapExecutor().run_round(
            ctx, gp, algo.round_payload(srv), [(), ()], data.clients[:2],
            np.random.default_rng(0), client_ids=[0, 1]).local_losses)
    assert isinstance(out[0], torch.Tensor) and out[0].device.type == "cuda"
    assert out[0].shape == (2,)
    np.testing.assert_allclose(out[0].tolist(), out[1], rtol=0, atol=TOL)


def test_short_fedgkd_run_launches_every_kernel(cuda):
    """The ResNet-8 path launches every kernel of its path."""
    task = scaled(CIFAR10, 0.02, rounds=1, local_epochs=1)
    data = fl_loop.make_federated_data(task, alpha=0.5, seed=0, n_test=64)
    reset_launches()
    hist = fl_loop.run_federated(task, algorithms.make("fedgkd"), data,
                                 max_batches_per_client=2)
    for name in ("kd_kl_fwd", "kd_kl_bwd", "grouped_conv_fwd",
                 "grouped_conv_dw"):
        assert LAUNCHES[name] > 0, LAUNCHES
    assert math.isfinite(hist.records[0].mean_local_loss)


# (B, S, Hq, Hkv, D, causal, window): the text path's local step, GQA with
# a window, a teacher chunk's B = 405, D = 128, one token, and non-causal
# at a ragged S = 100
FLASH = [(64, 64, 4, 4, 32, True, None), (3, 128, 8, 2, 64, True, 32),
         (405, 64, 4, 4, 32, True, None), (4, 64, 4, 2, 128, True, None),
         (64, 1, 4, 4, 32, True, None), (8, 100, 4, 4, 32, False, None)]


@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_attention_kernel_matches_plain(cuda, case):
    b, s, hq, hkv, d, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn(b, s, hq, d, device=cuda, generator=gen)
    k, v = (torch.randn(b, s, hkv, d, device=cuda, generator=gen)
            for _ in range(2))
    before = LAUNCHES["flash_attention_fwd"]
    got = fa_ops.flash_attention_fwd(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == before + 1
    _close(got, fa_ref.attention_ref(q, k, v, causal=causal, window=window))


def test_flash_attention_autograd_on_card(cuda):
    """Gradients through the op on the card (kernel forward, matmul
    backward) against autograd through the plain version on the card."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(4, 64, 8, 32, device=cuda, generator=gen)
    k, v = (torch.randn(4, 64, 2, 32, device=cuda, generator=gen)
            for _ in range(2))
    g = torch.randn(4, 64, 8, 32, device=cuda, generator=gen)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (fa_ops.flash_attention_gqa(*ins, window=16) * g).sum().backward()
    (fa_ref.attention_ref(*plain, window=16) * g).sum().backward()
    for a, b in zip(ins, plain):
        _close(a.grad, b.grad)


def test_short_text_fedgkd_run_launches_its_kernels(cuda):
    """AG News with the full-width encoder, through the sequential
    executor, launches flash attention and both KD-KL kernels."""
    task = scaled(AG_NEWS, 0.01, rounds=1)
    data = fl_loop.make_federated_data(task, alpha=0.5, seed=0, n_test=64)
    reset_launches()
    hist = fl_loop.run_federated(task, algorithms.make("fedgkd"), data,
                                 max_batches_per_client=2)
    assert hist.telemetry["route"] == "sequential"
    for name in ("flash_attention_fwd", "kd_kl_fwd", "kd_kl_bwd"):
        assert LAUNCHES[name] > 0, LAUNCHES
    assert math.isfinite(hist.records[0].mean_local_loss)


def _ssd_inputs(dev, shape, seed):
    """As the Mamba-2 layer makes them at init: A = -(1..H), dt a softplus
    around softplus(dt_bias) in [1e-3, 1e-1]."""
    b, l, h, p, g, n, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt0 = torch.exp(torch.rand(h, device=dev, generator=gen)
                    * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, h, device=dev, generator=gen)
        + dt0 + torch.log(-torch.expm1(-dt0)))
    A = -torch.arange(1, h + 1, device=dev, dtype=torch.float32)
    x = torch.randn(b, l, h, p, device=dev, generator=gen)
    B, C = (torch.randn(b, l, g, n, device=dev, generator=gen)
            for _ in range(2))
    return x, dt, A, B, C


# (B, L, H, P, G, N, chunk): the LM path's step, the smoke config's layer,
# two groups at a ragged length, one token, one sequence at train_4k's
# published length (16 chunks through the state pass), one chunk at full
# width, a chunk that is not a multiple of 16, P and N that are not
# multiples of 4 (4-byte copies), and the largest P and N at three groups
SSD = [(4, 1023, 80, 64, 1, 128, 256), (2, 39, 16, 16, 1, 16, 16),
       (1, 300, 8, 64, 2, 64, 128), (2, 1, 8, 64, 1, 128, 1),
       (1, 4096, 80, 64, 1, 128, 256), (1, 256, 80, 64, 1, 128, 256),
       (2, 200, 8, 64, 1, 128, 48), (1, 70, 4, 10, 1, 10, 32),
       (1, 130, 6, 128, 3, 256, 256)]


@pytest.mark.parametrize("case", SSD, ids=str)
def test_ssd_scan_kernel_matches_plain(cuda, case):
    args = _ssd_inputs(cuda, case, seed=sum(case))
    chunk = case[-1]
    before = LAUNCHES["ssd_scan_fwd"]
    y, state = ssd_ops.ssd_scan_fwd(*args, chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan_fwd"] == before + 1
    want = ssd_ref.ssd_scan_ref(*args, chunk)
    exact = ssd_ref.ssd_chunked(*(t.double() for t in args), chunk=chunk)
    for got, w, e in zip((y, state), want, exact):
        _close_or_nearer(got, w, e)


@pytest.mark.parametrize("layout", ["contiguous", "path slices", "offset"])
def test_ssd_scan_scratch_holds_entering_states(cuda, layout):
    """After a call the chunk-state scratch holds the state entering each
    chunk: stage 1's per-chunk states carried through stage 2's pass,
    against the plain form (``ref.entering_states``, the function
    ``ssd_chunked`` itself calls).  The inputs are contiguous, strided
    slices of one (B, L, H·P + 2·G·N) tensor as ``mamba2_forward`` passes
    them (16-byte copies), or those slices one float off alignment (4-byte
    copies)."""
    b, l, h, p, g, n, chunk = 2, 300, 8, 64, 2, 64, 64
    args = list(_ssd_inputs(cuda, (b, l, h, p, g, n, chunk), seed=21))
    if layout != "contiguous":
        shift = int(layout == "offset")
        xbc = torch.empty(b, l, shift + h * p + 2 * g * n, device=cuda)
        xbc = xbc[..., shift:]
        xbc[...] = torch.cat([args[0].reshape(b, l, -1),
                              args[3].reshape(b, l, -1),
                              args[4].reshape(b, l, -1)], dim=-1)
        args[0] = xbc[..., :h * p].reshape(b, l, h, p)
        args[3] = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
        args[4] = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    vec = ssd_ops.copy16(args[0].data_ptr(), args[0].stride(), p)
    assert vec == (layout != "offset")
    y, state, entering = ssd_ops.ssd_scan_launch(*args, chunk)
    torch.cuda.synchronize()
    want_entering, want_state = ssd_ref.entering_states(*args, chunk)
    assert entering.shape == want_entering.shape == (b, 5, h, p, n)
    _close(entering, want_entering)
    _close(state, want_state)
    _close(y, ssd_ref.ssd_scan_ref(*args, chunk)[0])


def test_ssd_scan_autograd_on_card(cuda):
    """Gradients through the op on the card (kernel forward, the plain
    chunked form's autograd backward) against autograd through the plain
    version on the card."""
    shape = (2, 100, 8, 32, 2, 32, 32)
    args = _ssd_inputs(cuda, shape, seed=9)
    gen = torch.Generator(device=cuda).manual_seed(10)
    wy = torch.randn(shape[:3] + shape[3:4], device=cuda, generator=gen)
    ws = torch.randn(2, 8, 32, 32, device=cuda, generator=gen)
    ins = [t.clone().requires_grad_(True) for t in args]
    plain = [t.clone().requires_grad_(True) for t in args]
    y, s = ssd_ops.ssd_scan(*ins, chunk=32)
    ((y * wy).sum() + (s * ws).sum()).backward()
    y, s = ssd_ref.ssd_chunked(*plain, chunk=32)
    ((y * wy).sum() + (s * ws).sum()).backward()
    for a, b in zip(ins, plain):
        _close(a.grad, b.grad)


@pytest.mark.parametrize("t,v", [(4092, 50280), (300, 1100), (1, 7)])
def test_row_logsumexp_kernel_and_backward(cuda, t, v):
    gen = torch.Generator(device=cuda).manual_seed(v)
    logits = torch.randn(t, v, device=cuda, generator=gen) * 3
    g = torch.randn(t, device=cuda, generator=gen)
    before = LAUNCHES["row_logsumexp"]
    live = logits.clone().requires_grad_(True)
    out = kd_ops.row_logsumexp(live, temperature=2.0)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert LAUNCHES["row_logsumexp"] == before + 1
    plain = logits.clone().requires_grad_(True)
    want = kd_ref.row_logsumexp_ref(plain, 2.0)
    (want * g).sum().backward()
    _close(out, want)
    _close(live.grad, plain.grad)


def test_lm_train_step_on_card_matches_cpu(cuda):
    """One FedGKD step of the smoke mamba2 LM on the card and on the CPU
    from the same params: loss and params after."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import lm_token_batches
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_leaves, tree_map

    import numpy as np

    cfg = get_smoke_config("mamba2-2.7b")
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    teacher = tree_map(lambda t: t * 0.9, params)
    toks = torch.from_numpy(lm_token_batches(np.random.default_rng(1), 2, 40,
                                             cfg.vocab_size))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = sgd(momentum=0.9)
    step = steps.make_train_step(cfg, opt, kd_mode="teacher", lr=0.1)
    out = {}
    for dev in ("cpu", cuda):
        on = lambda tree: tree_map(lambda t: t.to(dev), tree)  # noqa: E731
        p = on(params)
        reset_launches()
        new, _, m = step(p, on(teacher), opt.init(p), on(batch))
        out[str(dev)] = (tree_leaves(tree_map(torch.Tensor.cpu, new)),
                         float(m["loss"]), dict(LAUNCHES))
    (cpu, loss_cpu, _), (card, loss_card, launched) = out.values()
    for name in ("ssd_scan_fwd", "row_logsumexp", "kd_kl_fwd", "kd_kl_bwd"):
        assert launched[name] > 0, launched
    assert abs(loss_card - loss_cpu) < TOL * max(1.0, abs(loss_cpu))
    for a, b in zip(card, cpu, strict=True):
        _close(a, b)


@pytest.mark.parametrize("name", ["moon", "feddistill+"])
def test_baseline_client_step_on_card_matches_cpu(cuda, name):
    """One local step of MOON (three feature forwards, the projection head)
    and of FedDistill+ (B1/B2 against its label-logit table) at ResNet-8's
    full width on the card and on the CPU from the same params: loss and
    params after, and the kernels of the step launched."""
    from repro_torch.core import client, modelzoo
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_leaves, tree_map

    algo = algorithms.make(name)
    model = modelzoo.make_model(CIFAR10,
                                projection_head=algo.needs_projection_head)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    other = tree_map(lambda t: t + 0.01 * torch.randn(t.shape, generator=gen),
                     params)
    x = torch.randn(64, 32, 32, 3, generator=gen)
    y = torch.randint(0, 10, (64,), generator=gen)
    if name == "moon":
        payload, state = {"global": other}, {"prev": params}
    else:
        payload = {"label_logits": torch.randn(10, 10, generator=gen),
                   "enable": torch.ones(())}
        state = ()
    opt = sgd(momentum=0.9, weight_decay=1e-5)
    step = client.make_step(algo.loss_fn(model), opt)
    out = {}
    for dev in ("cpu", cuda):
        on = lambda tree: tree_map(lambda t: t.to(dev), tree)  # noqa: E731
        p = on(params)
        reset_launches()
        new, _, loss, _ = step(p, opt.init(p), on(payload), on(state),
                               x.to(dev), y.to(dev), None, (), 0.05)
        out[str(dev)] = (tree_leaves(tree_map(torch.Tensor.cpu, new)),
                         float(loss), dict(LAUNCHES))
    (cpu, loss_cpu, _), (card, loss_card, launched) = out.values()
    kernels = ["grouped_conv_fwd"] + (["kd_kl_fwd", "kd_kl_bwd"]
                                      if name == "feddistill+" else [])
    for k in kernels:
        assert launched[k] > 0, launched
    assert abs(loss_card - loss_cpu) < TOL * max(1.0, abs(loss_cpu))
    for a, b in zip(card, cpu, strict=True):
        _close(a, b)


def test_client_slab_store_on_card(cuda):
    """Slabs are tensors on the card holding ``make_slab``'s bytes; a
    repeat is a hit, "cuda" and "cuda:0" are one device, a drop forces a
    fresh upload, and the cap evicts the least recently used."""
    import numpy as np

    from repro_torch.data.pipeline import (ClientData, ClientSlabStore,
                                           make_slab, slab_rows)

    seen = []
    store = ClientSlabStore(max_resident=2,
                            on_evict=lambda cid, entry: seen.append(cid))
    rng = np.random.default_rng(0)
    datas = [ClientData(rng.normal(size=(n, 3, 4)).astype(np.float32),
                        rng.integers(0, 10, n)) for n in (5, 70, 130)]
    for cid, data in enumerate(datas):
        e = store.get(cid, data, "cuda")
        x, y = make_slab(data, slab_rows(data.n))
        assert e["x"].is_cuda and e["y"].dtype == torch.int32
        assert e["rows"] == slab_rows(data.n)
        np.testing.assert_array_equal(e["x"].cpu().numpy(), x)
        np.testing.assert_array_equal(e["y"].cpu().numpy(), y)
    assert seen == [0] and store.evictions == 1
    store.get(2, datas[2], torch.device("cuda", 0))
    assert store.hits == 1 and store.host_transfers == 3
    assert store.drop(1) and store.stats()["resident_clients"] == 1
    store.get(1, datas[1], "cuda")
    assert store.host_transfers == 4 and store.peak_resident == 2


def test_disk_population_equals_data_run_on_card(cuda, tmp_path):
    """ResNet-8 FedGKD from disk shards with a one-shard sampler is the
    ``data=`` run on the card: the same cohorts, params within 1e-6 (the
    card's runs repeat bit for bit), every pin released."""
    from repro_torch.population import (DiskShardSource, HierarchicalSampler,
                                        Population, write_population_shards)
    from repro_torch.tree import tree_leaves

    task = scaled(CIFAR10, 0.02, rounds=2, local_epochs=1)
    data = fl_loop.make_federated_data(task, alpha=0.5, seed=0, n_test=64)
    write_population_shards(str(tmp_path), iter(data.clients), shard_size=3)
    pop = Population(DiskShardSource(str(tmp_path)), data.test_x,
                     data.test_y, warm_cap=2)
    pop.sampler = HierarchicalSampler([pop.n_clients])
    kw = dict(seed=0, max_batches_per_client=2)
    reset_launches()
    h1 = fl_loop.run_federated(task, algorithms.make("fedgkd"),
                               population=pop, **kw)
    for name in ("kd_kl_fwd", "kd_kl_bwd", "grouped_conv_fwd"):
        assert LAUNCHES[name] > 0, LAUNCHES
    h0 = fl_loop.run_federated(task, algorithms.make("fedgkd"), data, **kw)
    assert [r.sampled for r in h0.records] == [r.sampled for r in h1.records]
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(h0.final_params), tree_leaves(h1.final_params),
        strict=True))
    assert diff <= 1e-6
    assert h1.telemetry["population"]["pinned"] == 0


def _resnet_fixture(n_clients=8, participation=0.5):
    """A small ResNet-8 cut (32x32, 2 batches of 64 a client) of the
    ResNet-8 path's setup: K = 4 of 8."""
    import dataclasses

    task = dataclasses.replace(scaled(CIFAR10, 0.02, rounds=2, local_epochs=1),
                               n_clients=n_clients,
                               participation=participation)
    data = fl_loop.make_federated_data(task, alpha=0.5, seed=0, n_test=64)
    return task, data, dict(seed=0, max_batches_per_client=2)


def _max_diff(a, b):
    from repro_torch.tree import tree_leaves

    return max(float((x - y).abs().max()) for x, y in zip(
        tree_leaves(a), tree_leaves(b), strict=True))


@pytest.mark.parametrize("participation", [0.5, 0.375])
def test_shard_map_two_slices_on_card_equal_vmap(cuda, participation):
    """``ShardMapExecutor(strict=True)`` with two slices on one card, K=4
    and K=3 (one phantom client): FedGKD within 1e-5 of the vmap
    executor's run, B1-B3 launched, the slabs resident on the card."""
    from repro_torch.core.executor import ShardMapExecutor

    task, data, kw = _resnet_fixture(participation=participation)
    hv = fl_loop.run_federated(task, algorithms.make("fedgkd"), data,
                               executor="vmap", **kw)
    reset_launches()
    hs = fl_loop.run_federated(
        task, algorithms.make("fedgkd"), data,
        executor=ShardMapExecutor(strict=True, devices=["cuda:0"] * 2), **kw)
    for name in ("kd_kl_fwd", "kd_kl_bwd", "grouped_conv_fwd"):
        assert LAUNCHES[name] > 0, LAUNCHES
    tele = hs.telemetry
    assert tele["route"] == "shard_map" and tele["n_devices"] == 2
    assert tele["padded_to"] == 4 and tele["round_body"] == "client_batched"
    assert tele["placement"]["host_transfers"] > 0
    assert [r.sampled for r in hs.records] == [r.sampled for r in hv.records]
    assert _max_diff(hs.final_params, hv.final_params) < TOL


_PLACED_WORKER = """\
import json, sys
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
host, exch, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, sys.argv[4])
from test_torch_gpu import _resnet_fixture
from repro_torch.core import algorithms, fl_loop
from repro_torch.kernels import LAUNCHES
from repro_torch.population import HostPlacement, Population
from repro_torch.tree import tree_leaves
task, data, kw = _resnet_fixture()
pop = Population.from_federated(data, n_shards=4, placement=HostPlacement(
    host, 2, exchange_dir=exch, timeout_s=300))
h = fl_loop.run_federated(task, algorithms.make("fedgkd"), population=pop,
                          **kw)
np.savez(out, acc=np.float64(h.final_acc), launches=np.asarray(
    [LAUNCHES[k] for k in ("kd_kl_fwd", "kd_kl_bwd", "grouped_conv_fwd")]),
    **{f"p{i:03d}": t.cpu().numpy()
       for i, t in enumerate(tree_leaves(h.final_params))})
"""


def test_two_process_placement_on_card_equals_one_host(cuda, tmp_path):
    """Two processes on the card, each owning 2 of 4 shards of the
    population: they agree bitwise, each launched B1-B3, and they equal
    the one-host run of the same population within 1e-5."""
    import os
    import subprocess
    import sys

    import numpy as np

    from repro_torch.population import Population
    from repro_torch.tree import tree_leaves

    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(tests, "..", "src"))
    worker = tmp_path / "worker.py"
    worker.write_text(_PLACED_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(h), str(tmp_path / "exchange"),
         str(tmp_path / f"host{h}.npz"), tests], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for h in range(2)]
    for h, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"host {h}:\n{out[-4000:]}"
    hosts = [dict(np.load(tmp_path / f"host{h}.npz")) for h in range(2)]
    for k in hosts[0]:
        np.testing.assert_array_equal(hosts[0][k], hosts[1][k], err_msg=k)
    assert all(n > 0 for n in hosts[0]["launches"])
    task, data, kw = _resnet_fixture()
    one = fl_loop.run_federated(task, algorithms.make("fedgkd"),
                                population=Population.from_federated(
                                    data, n_shards=4), **kw)
    diff = max(float(np.abs(t.cpu().numpy() - hosts[0][f"p{i:03d}"]).max())
               for i, t in enumerate(tree_leaves(one.final_params)))
    assert diff < TOL


# (B, S, Hq, Hkv, D, window): the serve path's head layouts, phi4-mini's and
# minitron's GQA 24/8, granite's MQA 48/1, internlm2's 48/8 at head_dim 128,
# zamba2's shared block 32/32 at 64, and phi4-mini's window cut to 64
LM_FLASH = [(2, 256, 24, 8, 128, None), (2, 256, 48, 1, 128, None),
            (2, 256, 48, 8, 128, None), (2, 256, 32, 32, 64, None),
            (1, 160, 24, 8, 128, 64)]


@pytest.mark.parametrize("case", LM_FLASH, ids=str)
def test_flash_attention_at_lm_head_layouts(cuda, case):
    b, s, hq, hkv, d, window = case
    gen = torch.Generator(device=cuda).manual_seed(hq + d)
    q = torch.randn(b, s, hq, d, device=cuda, generator=gen)
    k, v = (torch.randn(b, s, hkv, d, device=cuda, generator=gen)
            for _ in range(2))
    before = LAUNCHES["flash_attention_fwd"]
    got = fa_ops.flash_attention_fwd(q, k, v, True, window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == before + 1
    _close(got, fa_ref.attention_ref(q, k, v, window=window))


# (B, L, H, P, G, N, chunk) from an entering state: zamba2's width, the
# smoke config's layer, and P, N that are not multiples of 4
SSD_INIT = [(2, 300, 64, 64, 1, 64, 256), (2, 39, 16, 16, 1, 16, 16),
            (1, 70, 4, 10, 1, 10, 32)]


@pytest.mark.parametrize("case", SSD_INIT, ids=str)
def test_ssd_scan_kernel_from_an_entering_state(cuda, case):
    b, l, h, p, g, n, chunk = case
    args = _ssd_inputs(cuda, case, seed=sum(case) + 1)
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    init = torch.randn(b, h, p, n, device=cuda, generator=gen)
    before = LAUNCHES["ssd_scan_fwd"]
    y, state, entering = ssd_ops.ssd_scan_launch(*args, chunk, init)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan_fwd"] == before + 1
    want = ssd_ref.ssd_scan_ref(*args, chunk, init)
    exact = ssd_ref.ssd_chunked(*(t.double() for t in args), chunk=chunk,
                                init_state=init.double())
    for got, w, e in zip((y, state), want, exact):
        _close_or_nearer(got, w, e)
    _close(entering, ssd_ref.entering_states(*args, chunk, init)[0])


def test_ssd_scan_autograd_from_an_entering_state(cuda):
    """The entering state's gradient and the others' through the op on the
    card against autograd through the plain version on the card."""
    shape = (2, 100, 8, 32, 2, 32, 32)
    args = _ssd_inputs(cuda, shape, seed=12)
    gen = torch.Generator(device=cuda).manual_seed(13)
    init = torch.randn(2, 8, 32, 32, device=cuda, generator=gen)
    wy = torch.randn(2, 100, 8, 32, device=cuda, generator=gen)
    ws = torch.randn(2, 8, 32, 32, device=cuda, generator=gen)
    ins = [t.clone().requires_grad_(True) for t in (*args, init)]
    plain = [t.clone().requires_grad_(True) for t in (*args, init)]
    y, s = ssd_ops.ssd_scan(*ins[:5], chunk=32, init_state=ins[5])
    ((y * wy).sum() + (s * ws).sum()).backward()
    y, s = ssd_ref.ssd_chunked(*plain[:5], chunk=32, init_state=plain[5])
    ((y * wy).sum() + (s * ws).sum()).backward()
    for a, b in zip(ins, plain):
        _close(a.grad, b.grad)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "minitron-4b",
                                  "granite-34b", "internlm2-20b",
                                  "zamba2-1.2b", "mamba2-2.7b"])
def test_decode_matches_forward_on_card(cuda, arch):
    """Greedy decode through the caches against the teacher-forced forward
    (B4 and B5 on the card), at the smoke config, within the reference's
    bar (2e-3, tests/test_arch_smoke.py); the decode logits also against
    the CPU's decode from the same params."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    cfg = get_smoke_config(arch)
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    step = make_serve_step(cfg)
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        cache = transformer.init_cache(cfg, 2, 16, torch.float32, device=dev)
        logits = []
        for i in range(12):
            lg, cache = step(p, cache, toks[:, i:i + 1].to(dev))
            logits.append(lg[:, 0])
        out[str(dev)] = (p, torch.stack(logits, 1))
    p, dec = out[str(cuda)]
    reset_launches()
    with torch.no_grad():
        full, _ = transformer.forward(p, cfg, toks.to(cuda))
    kernel = "ssd_scan_fwd" if arch == "mamba2-2.7b" else "flash_attention_fwd"
    assert LAUNCHES[kernel] > 0, LAUNCHES
    if arch == "zamba2-1.2b":
        assert LAUNCHES["ssd_scan_fwd"] > 0, LAUNCHES
    torch.testing.assert_close(dec, full, rtol=0, atol=2e-3)
    _close(dec.cpu(), out["cpu"][1])


# ----------------------------------------------------------------- bf16

BF16_FLASH_TOL = 2e-2      # the reference's bf16 bar for flash attention


def _bf16_close(got, want):
    """``got`` (bf16) within one bf16 ulp of ``want`` (fp32) rounded to
    bf16, plus the fp32 bar."""
    assert got.dtype == torch.bfloat16
    w = want.to(torch.bfloat16).to(torch.float32)
    _, e = torch.frexp(w)
    ulp = torch.where(w != 0, torch.ldexp(torch.ones_like(w), e - 8),
                      torch.zeros_like(w))
    err = (got.to(torch.float32) - w).abs()
    bar = ulp + TOL * max(1.0, float(want.abs().max()))
    assert bool((err <= bar).all()), float((err - bar).max())


# (B, S, Hq, Hkv, D, window[, layout]): phi4-mini's and zamba2's head
# layouts, the ring gate's window and an odd head_dim; mixtral's step
# (32/8 heads, its window of 4,096 past the sequence); S = 1,024 at D = 128
# and 64 (many q tiles, causal skipping), a ragged S = 1,000, a window of
# 100 across tile boundaries, MQA, a head_dim of 7 (staged by plain loads:
# rows not 16-byte aligned), q, k and v as strided views of one fused
# (B, S, (Hq + 2 Hkv) D) projection, and non-causal at a ragged S;
# seamless-m4t's encoder (non-causal at 384), its decoder's cross-attention
# ("cross", Skv: 1,024 queries and one decode query against 384 keys) and
# llava-next's GQA group of 7 (56/8 heads)
BF16_FLASH_CASES = [(2, 256, 24, 8, 128, None), (2, 256, 32, 32, 64, None),
                    (1, 160, 24, 8, 128, 64), (2, 100, 4, 4, 40, None),
                    (2, 1024, 24, 8, 128, None), (2, 1024, 32, 32, 64, None),
                    (2, 1024, 32, 8, 128, 4096),
                    (1, 1000, 8, 2, 128, None), (1, 300, 8, 2, 128, 100),
                    (2, 16, 48, 1, 128, None),
                    (2, 37, 6, 3, 7, None),
                    (2, 300, 24, 8, 128, None, "fused"),
                    (2, 200, 8, 2, 64, None, "non-causal"),
                    (2, 384, 16, 16, 64, None, "non-causal"),
                    (2, 1024, 16, 16, 64, None, "cross", 384),
                    (2, 1, 16, 16, 64, None, "cross", 384),
                    (2, 1024, 56, 8, 128, None)]


@pytest.mark.parametrize("case", BF16_FLASH_CASES, ids=str)
def test_flash_attention_bf16_kernel_matches_plain(cuda, case):
    b, s, hq, hkv, d, window, *layout = case
    causal = not layout or layout[0] not in ("non-causal", "cross")
    skv = layout[1] if layout and layout[0] == "cross" else s
    gen = torch.Generator(device=cuda).manual_seed(hq + d + 1)
    if layout == ["fused"]:
        qkv = torch.randn(b, s, (hq + 2 * hkv) * d, device=cuda,
                          generator=gen).bfloat16()
        q, k, v = (t.unflatten(-1, (-1, d)) for t in
                   qkv.split([hq * d, hkv * d, hkv * d], dim=-1))
        assert not q.is_contiguous() and k.stride(1) == (hq + 2 * hkv) * d
    else:
        q = torch.randn(b, s, hq, d, device=cuda, generator=gen).bfloat16()
        k, v = (torch.randn(b, skv, hkv, d, device=cuda, generator=gen)
                .bfloat16() for _ in range(2))
    before = dict(LAUNCHES)
    got = fa_ops.flash_attention_fwd(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd_bf16"] == (
        before["flash_attention_fwd_bf16"] + 1)
    assert LAUNCHES["flash_attention_fwd"] == before["flash_attention_fwd"]
    _bf16_close(got, fa_ref.attention_ref(q.float(), k.float(), v.float(),
                                          causal=causal, window=window))
    torch.testing.assert_close(
        got.float(), fa_ref.attention_ref(q, k, v, causal=causal,
                                          window=window).float(),
        rtol=BF16_FLASH_TOL, atol=BF16_FLASH_TOL)


def test_flash_attention_bf16_autograd_and_refusals(cuda):
    """bf16 gradients through the op (the fp32 backward, cast to the
    inputs' dtypes); a dtype without a kernel form raises."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(2, 64, 8, 32, device=cuda, generator=gen).bfloat16()
    k, v = (torch.randn(2, 64, 2, 32, device=cuda, generator=gen).bfloat16()
            .requires_grad_(True) for _ in range(2))
    q.requires_grad_(True)
    fa_ops.flash_attention_gqa(q, k, v).float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (q, k, v))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa_ops.flash_attention_fwd(q.detach().half(), k.detach().half(),
                                   v.detach().half())


@pytest.mark.parametrize("t,v", [(2048, 200_064), (256, 10), (1000, 37)])
def test_kd_kl_and_row_lse_bf16_kernels_match_plain(cuda, t, v):
    gen = torch.Generator(device=cuda).manual_seed(t + v + 1)
    lt, ls = ((torch.randn(t, v, device=cuda, generator=gen) * 2).bfloat16()
              for _ in range(2))
    g = torch.randn(t, device=cuda, generator=gen)
    before = dict(LAUNCHES)
    kl, lse_t, lse_s = kd_ops.kd_kl_fwd(lt, ls, 1.0)
    dls = kd_ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, 1.0)
    lse = kd_ops.row_lse_fwd(ls, 1.0)
    torch.cuda.synchronize()
    for name in ("kd_kl_fwd", "kd_kl_bwd", "row_logsumexp"):
        assert LAUNCHES[name + "_bf16"] == before[name + "_bf16"] + 1
        assert LAUNCHES[name] == before[name]
    lt32, ls32 = lt.float(), ls.float()
    for got, want in zip((kl, lse_t, lse_s),
                         kd_ref.kd_kl_fwd_ref(lt32, ls32, 1.0)):
        assert got.dtype == torch.float32
        _close(got, want)
    _bf16_close(dls, kd_ref.kd_kl_bwd_ref(lt32, ls32, lse_t, lse_s, g, 1.0))
    _close(lse, kd_ref.row_logsumexp_ref(ls32, 1.0))


def test_kd_kl_mixed_dtypes_and_refusals(cuda):
    """An fp32 teacher against a bf16 student meets in fp32 (the fp32
    kernels), dls in the student's bf16; another dtype raises."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    lt = torch.randn(64, 100, device=cuda, generator=gen)
    ls = torch.randn(64, 100, device=cuda, generator=gen).bfloat16()
    g = torch.randn(64, device=cuda, generator=gen)
    kl, lse_t, lse_s = kd_ops.kd_kl_fwd(lt, ls, 1.0)
    dls = kd_ops.kd_kl_bwd(lt, ls, lse_t, lse_s, g, 1.0)
    torch.cuda.synchronize()
    want = kd_ref.kd_kl_fwd_ref(lt, ls.float(), 1.0)
    for got, w in zip((kl, lse_t, lse_s), want):
        _close(got, w)
    _bf16_close(dls, kd_ref.kd_kl_bwd_ref(lt, ls.float(), *want[1:], g, 1.0))
    with pytest.raises(TypeError):
        kd_ops.kd_kl_fwd(lt.half(), ls.half(), 1.0)


# B1's geometries (csrc/kd_kl.cu: a warp per row below kBlockVocab = 1,024
# columns, a block of 512 threads per row from there with 16-byte loads): a
# vocab on each side of the threshold, odd vocabularies on the large side
# (rows not 16-byte aligned), seamless-m4t's 256,206
KD_FWD_SHAPES = [(64, 1023), (64, 1024), (5, 4097), (3, 256_206)]
# "offset": both bases one element past a 16-byte boundary (a head is
# peeled); "teacher offset": the teacher's only, so the two rows never
# align together and the block form reads both with scalar loads
KD_FWD_LAYOUTS = ["contiguous", "offset", "teacher offset"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", KD_FWD_LAYOUTS)
@pytest.mark.parametrize("t,v", KD_FWD_SHAPES)
def test_kd_kl_fwd_geometries_and_alignment(cuda, t, v, layout, dtype):
    """B1 against the plain version (the fp32 one on bf16 values upcast) at
    both geometries and every alignment, with a row of equal teacher
    logits (row 0) and a row where the student equals the teacher (row 1:
    KL ~0 within the bar); two calls give bitwise-equal outputs."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(t + v)

    def logits(offset):
        flat = (torch.randn(t * v + offset, device=cuda, generator=gen)
                * 2).to(dt)
        return flat[offset:].view(t, v)

    lt = logits(0 if layout == "contiguous" else 1)
    ls = logits(1 if layout == "offset" else 0)
    assert lt.is_contiguous() and ls.is_contiguous()
    assert (lt.data_ptr() % 16 != 0) == (layout != "contiguous")
    lt[0] = 0.75
    ls[1] = lt[1]
    before = dict(LAUNCHES)
    counter = "kd_kl_fwd" + ("_bf16" if dtype == "bfloat16" else "")
    got = kd_ops.kd_kl_fwd(lt, ls, 2.0)
    again = kd_ops.kd_kl_fwd(lt, ls, 2.0)
    torch.cuda.synchronize()
    assert LAUNCHES[counter] == before[counter] + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for a, w in zip(got, kd_ref.kd_kl_fwd_ref(lt.float(), ls.float(), 2.0)):
        assert a.dtype == torch.float32
        _close(a, w)
    assert abs(float(got[0][1])) <= TOL


def test_ssd_scan_casting_wrapper_in_bf16(cuda):
    """B5 through its wrapper on bf16 x, B and C at zamba2's width: the fp32
    kernels (counted as ``ssd_scan_fwd``) on the inputs cast up, y in
    bf16, the final state fp32."""
    shape = (2, 300, 64, 64, 1, 64, 256)
    x, dt, A, B, C = _ssd_inputs(cuda, shape, seed=21)
    x, B, C = (t.bfloat16() for t in (x, B, C))
    before = dict(LAUNCHES)
    y, state = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=256)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan_fwd"] == before["ssd_scan_fwd"] + 1
    assert (y.dtype, state.dtype) == (torch.bfloat16, torch.float32)
    args = (x.float(), dt, A, B.float(), C.float())
    want = ssd_ref.ssd_scan_ref(*args, 256)
    exact = ssd_ref.ssd_chunked(*(t.double() for t in args), chunk=256)
    _close_or_nearer(state, want[1], exact[1])
    _bf16_close(y, want[0])


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "zamba2-1.2b",
                                  "mixtral-8x7b"])
def test_bf16_decode_matches_forward_on_card(cuda, arch):
    """A bf16 smoke model's greedy decode over bf16 caches (the default)
    against its teacher-forced forward (B4 in bf16 on the card), both held
    to the forward in fp32 from the same weights upcast."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    cfg = get_smoke_config(arch).replace(param_dtype="bfloat16",
                                         activation_dtype="bfloat16")
    if cfg.moe is not None:      # lossless: decode keeps what forward keeps
        cfg = cfg.replace(moe=cfg.moe._replace(
            capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    params = tree_map(lambda t: t.to(cuda), transformer.init(
        torch.Generator().manual_seed(0), cfg))
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    step = make_serve_step(cfg)
    cache = transformer.init_cache(cfg, 2, 16, device=cuda)
    assert cache["seg0"][0].dtype == torch.bfloat16
    dec = []
    for i in range(12):
        lg, cache = step(params, cache, toks[:, i:i + 1])
        dec.append(lg[:, 0])
    dec = torch.stack(dec, 1)
    reset_launches()
    with torch.no_grad():
        full, _ = transformer.forward(params, cfg, toks)
        full32, _ = transformer.forward(
            tree_map(lambda t: t.float(), params),
            cfg.replace(param_dtype="float32", activation_dtype="float32"),
            toks)
    assert LAUNCHES["flash_attention_fwd_bf16"] > 0, LAUNCHES
    e_full = float((full - full32).abs().max())
    e_dec = float((dec - full32).abs().max())
    bar = max(2 * e_full, 2.0 ** -8 * float(full32.abs().max()))
    assert e_dec <= bar, (e_dec, e_full, bar)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_at_mixtral_width_matches_the_cpu(cuda, dtype):
    """One MoE layer of mixtral-8x7b at full width (8 experts of 4,096 x
    14,336, top-2) on 256 tokens at capacity factor 0.5 (32 slots an
    expert, so entries drop), on the card against the CPU from the same
    weights (drawn on the card): fp32 to 1e-5 of max|CPU|; bf16 held as a
    bf16 model's decode is held, to the layer in fp32 on the CPU from the
    same values upcast: no further from it than twice the CPU's bf16
    layer, or one bf16 ulp of its magnitude (one ulp of the CPU's bf16
    output does not hold: h is rounded to bf16 between the up and down
    products, and the two devices' 4,096-deep sums round some of its
    values to neighbouring bf16 values, which the 14,336-deep down product
    carries past an ulp of the output); the same entries dropped; the
    load-balance loss to 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    dt = getattr(torch, dtype)
    cfg = get_config("mixtral-8x7b").moe._replace(capacity_factor=0.5)
    params = moe.moe_init(torch.Generator(device=cuda).manual_seed(0), cfg,
                          dt)
    x = torch.randn(2, 128, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    x = x.to(dt)
    drops = {}
    real = moe.dispatch_plan

    def spy(top_idx, cap, n_experts):
        slot, keep = real(top_idx, cap, n_experts)
        drops[top_idx.device.type] = keep.cpu()
        return slot, keep

    moe.dispatch_plan = spy
    try:
        with torch.no_grad():
            out, aux = moe.moe_apply(params, x, cfg)
            cpu_out, cpu_aux = moe.moe_apply(
                tree_map(lambda t: t.cpu(), params), x.cpu(), cfg)
    finally:
        moe.dispatch_plan = real
    assert out.dtype == cpu_out.dtype == dt
    assert torch.equal(drops["cuda"], drops["cpu"])
    assert int((~drops["cpu"]).sum()) > 0
    assert abs(float(aux) - float(cpu_aux)) <= TOL * float(cpu_aux)
    if dt == torch.float32:
        _close(out.cpu(), cpu_out)
        return
    with torch.no_grad():
        out32, _ = moe.moe_apply(tree_map(lambda t: t.cpu().float(), params),
                                 x.cpu().float(), cfg)
    e_card = float((out.cpu().float() - out32).abs().max())
    e_cpu = float((cpu_out.float() - out32).abs().max())
    bar = max(2 * e_cpu, 2.0 ** -8 * float(out32.abs().max()))
    assert e_card <= bar, (e_card, e_cpu, bar)


def test_run_sharded_on_a_repeated_card_equals_run_serial(cuda):
    """Two clients on one card (``devices=[card] * 2``) against
    ``run_serial``'s two clients, bf16 as published: equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    cfg = get_smoke_config("phi4-mini-3.8b").replace(
        param_dtype="bfloat16", activation_dtype="bfloat16")
    kw = dict(rounds=1, batches_per_round=2, batch=2, seq=33, verbose=False)
    reset_launches()
    sharded = train.run_sharded(cfg, devices=[cuda] * 2, **kw)
    assert LAUNCHES["flash_attention_fwd_bf16"] > 0, LAUNCHES
    serial = train.run_serial(cfg, n_clients=2, device=cuda, **kw)
    for a, b in zip(tree_leaves(sharded["params"]),
                    tree_leaves(serial["params"]), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert sharded["history"][0]["ppl"] == serial["history"][0]["ppl"]


def test_grouped_conv_refuses_bf16_on_card(cuda):
    """B3 has no bf16 form (no path of the reference runs a conv in bf16):
    a bf16 tensor on the card raises, and nothing falls back."""
    x = torch.zeros(1, 2, 8, 8, 4, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(1, 3, 3, 4, 8, device=cuda, dtype=torch.bfloat16)
    before = dict(LAUNCHES)
    with pytest.raises(TypeError, match="float32"):
        conv_ops.grouped_conv_fwd(x, w, 1, "SAME")
    assert dict(LAUNCHES) == before
