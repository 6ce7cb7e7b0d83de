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
cumsums), to being no further from float64 than the plain version is.
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
    K=4 clients: the rule folds the vmapped axis into K (one launch), and
    the output and both gradients agree with the plain versions."""
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

    before = LAUNCHES["grouped_conv_fwd"]
    dx, dw = vmap(grad(one, argnums=(0, 1)))(x, w, dy)
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_conv_fwd"] == before + 1
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
    for name in ("kd_kl_fwd", "kd_kl_bwd", "grouped_conv_fwd"):
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


def _ssd_close(got, want, exact):
    """Within TOL of the plain version, or no further from float64."""
    err = float((got - want).abs().max())
    if err <= TOL * max(1.0, float(want.abs().max())):
        return
    assert (float((got.double() - exact).abs().max())
            <= float((want.double() - exact).abs().max())), err


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
        _ssd_close(got, w, e)


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
