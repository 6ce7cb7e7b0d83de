"""The port's client-batched conv against the reference's, on the CPU.

Forward against the reference's Pallas kernel in interpret mode (as its
own tests run it), and the input and filter gradients against its custom
VJP, within 1e-5 absolute in fp32.  The cases are every conv geometry of
ResNet-8 at width 16 (K=3 clients, N=2 examples), including the stride-2
SAME convs whose pads are asymmetric (0 before, 1 after), a K=1 case, an
odd input size and a VALID case.  The CUDA kernel is held against the
plain version on the card by ``test_torch_gpu.py``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.grouped_conv import ops as jax_ops  # noqa: E402
from repro_torch.kernels.grouped_conv import ops, ref  # noqa: E402

# (K, N, H, Cin, Cout, k, stride, padding)
RESNET8 = [
    (3, 2, 32, 3, 16, 3, 1, "SAME"),     # stem
    (3, 2, 32, 16, 16, 3, 1, "SAME"),    # block1.conv1 / conv2
    (3, 2, 32, 16, 32, 3, 2, "SAME"),    # block2.conv1, pads 0/1
    (3, 2, 16, 32, 32, 3, 1, "SAME"),    # block2.conv2
    (3, 2, 32, 16, 32, 1, 2, "SAME"),    # block2.proj
    (3, 2, 16, 32, 64, 3, 2, "SAME"),    # block3.conv1, pads 0/1
    (3, 2, 8, 64, 64, 3, 1, "SAME"),     # block3.conv2
    (3, 2, 16, 32, 64, 1, 2, "SAME"),    # block3.proj
]
EXTRA = [
    (1, 3, 16, 16, 32, 3, 2, "SAME"),    # K=1: the single-client route
    (2, 2, 9, 4, 8, 3, 2, "SAME"),       # odd H: pads 1/1
    (2, 2, 11, 4, 4, 3, 2, "VALID"),     # VALID with a non-dividing stride
]
TOL = 1e-5


def _ids(c):
    return f"K{c[0]}H{c[2]}c{c[3]}-{c[4]}k{c[5]}s{c[6]}{c[7]}"


def _case(seed, K, N, H, Cin, Cout, kh, stride, padding):
    rng = np.random.default_rng(seed)
    oh = ref.resolve_pads(H, kh, stride, padding)[0]
    # He-scaled filters and a cotangent scaled by 1/sqrt(N·OH·OW) keep y, dx
    # and dw all O(1), where fp32 resolves the 1e-5 absolute bar
    x = rng.standard_normal((K, N, H, H, Cin)).astype(np.float32)
    w = (rng.standard_normal((K, kh, kh, Cin, Cout))
         / np.sqrt(kh * kh * Cin)).astype(np.float32)
    dy = (rng.standard_normal((K, N, oh, oh, Cout))
          / np.sqrt(N * oh * oh)).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("case", RESNET8 + EXTRA, ids=_ids)
def test_conv_and_gradients_match_reference(case):
    K, N, H, Cin, Cout, kh, s, pad = case
    x, w, dy = _case(sum(case[:6]), *case)

    def jax_obj(x_, w_):
        y = jax_ops.client_batched_conv(x_, w_, stride=s, padding=pad,
                                        use_pallas=True, interpret=True)
        return jnp.sum(y * dy), y

    (_, jy), (jdx, jdw) = jax.jit(jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True))(x, w)

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = ops.client_batched_conv(tx, tw, stride=s, padding=pad)
    (y * torch.from_numpy(dy)).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                               rtol=0, atol=TOL)


def test_same_pads_are_asymmetric_like_jax():
    assert ref.same_pads(32, 3, 2) == (16, 0, 1)
    assert ref.same_pads(32, 1, 2) == (16, 0, 0)
    assert ref.same_pads(9, 3, 2) == (5, 1, 1)
    assert ref.same_pads(32, 3, 1) == (32, 1, 1)


def test_rejects_mismatched_clients():
    with pytest.raises(ValueError, match="client axes"):
        ops.client_batched_conv(torch.zeros(2, 1, 4, 4, 3),
                                torch.zeros(3, 3, 3, 3, 8))

