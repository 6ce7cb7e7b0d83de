"""The port's fused KD-KL loss against the reference's Pallas kernel.

On the CPU the port's wrappers take their plain versions; the reference runs
its Pallas kernel in interpret mode, as its own tests do.  Forward value
and student gradient agree within 1e-5 absolute (fp32, the reference's
bar) on unit-scale logits, where the loss is O(1) and fp32 resolves that
bar; the teacher gets no gradient.  The CUDA kernels are held
against these plain versions on the card by ``test_torch_gpu.py``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.kd_kl import ops as jax_ops  # noqa: E402
from repro_torch.kernels.kd_kl import ops, ref  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

CASES = [(7, 10), (64, 100), (33, 200)]
TEMPS = [1.0, 2.0]
TOL = 1e-5


def _logits(t, v, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, v)).astype(np.float32),
            rng.standard_normal((t, v)).astype(np.float32),
            rng.standard_normal(t).astype(np.float32))


@pytest.mark.parametrize("temp", TEMPS)
@pytest.mark.parametrize("t,v", CASES)
def test_kd_kl_matches_reference_kernel(t, v, temp):
    lt, ls, g = _logits(t, v, seed=t * 1000 + v)

    def jax_obj(ls_):
        kl = jax_ops.kd_kl_loss(jnp.asarray(lt), ls_, temperature=temp,
                                block_rows=16, block_vocab=128,
                                use_pallas=True, interpret=True)
        return jnp.sum(kl * g), kl

    (_, jkl), jgrad = jax.value_and_grad(jax_obj, has_aux=True)(jnp.asarray(ls))

    tlt = torch.from_numpy(lt).requires_grad_(True)
    tls = torch.from_numpy(ls).requires_grad_(True)
    kl = ops.kd_kl_loss(tlt, tls, temperature=temp)
    (kl * torch.from_numpy(g)).sum().backward()

    np.testing.assert_allclose(kl.detach().numpy(), np.asarray(jkl),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tls.grad.numpy(), np.asarray(jgrad),
                               rtol=0, atol=TOL)
    assert tlt.grad is None or not bool(tlt.grad.any())


def test_kd_kl_keeps_leading_dims():
    lt, ls, _ = _logits(12, 10, seed=5)
    out = ops.kd_kl_loss(torch.from_numpy(lt).reshape(3, 4, 10),
                         torch.from_numpy(ls).reshape(3, 4, 10))
    assert out.shape == (3, 4)

