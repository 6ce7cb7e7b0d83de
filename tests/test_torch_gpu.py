"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA card; this file
imports no JAX, so it runs on the card's host as it is:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

The plain versions are the fp32 references, so TF32 is switched off for
each test.  Tolerance: 1e-5 of the plain version's largest magnitude, and
of no less than 1 (fp32, different summation orders): with one class the
KL is exactly 0 in the plain version, while the kernel forms it as a
difference of O(|logit|) terms and keeps a rounding residue of ~1e-7.
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

pytestmark = pytest.mark.gpu
TOL = 1e-5

# (K, N, H, Cin, Cout, k, stride): ResNet-8's convs at width 16 and K=4,
# a K=1 teacher/eval shape, and an odd input size
CONVS = [(4, 64, 32, 3, 16, 3, 1), (4, 64, 32, 16, 16, 3, 1),
         (4, 64, 32, 16, 32, 3, 2), (4, 64, 16, 32, 32, 3, 1),
         (4, 64, 32, 16, 32, 1, 2), (4, 64, 16, 32, 64, 3, 2),
         (4, 64, 8, 64, 64, 3, 1), (4, 64, 16, 32, 64, 1, 2),
         (1, 256, 32, 3, 16, 3, 1), (2, 3, 9, 4, 8, 3, 2)]


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


# (B, S, Hq, Hkv, D, window): the text path's local step, GQA with a window
FLASH = [(64, 64, 4, 4, 32, None), (3, 128, 8, 2, 64, 32)]


@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_attention_kernel_matches_plain(cuda, case):
    b, s, hq, hkv, d, window = case
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn(b, s, hq, d, device=cuda, generator=gen)
    k, v = (torch.randn(b, s, hkv, d, device=cuda, generator=gen)
            for _ in range(2))
    before = LAUNCHES["flash_attention_fwd"]
    got = fa_ops.flash_attention_fwd(q, k, v, True, window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == before + 1
    _close(got, fa_ref.attention_ref(q, k, v, window=window))


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
