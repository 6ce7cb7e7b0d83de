"""The Mamba-2 (SSD, state-space duality) block over plain-dict params.

The port of ``repro.models.ssm``: the config, the initializer (the
reference's keys and shapes), ``mamba2_forward`` (training and prefill,
from a zero or a given initial state) and the decode path (``SSMCache``,
``ssm_cache_init``, ``mamba2_decode_step``: O(1) a token, the rolling
conv state and the (H, P, N) SSM state).  The chunked SSD scan goes
through ``kernels.ssd_scan.ops.ssd_scan``: the CUDA kernel on a card, its
plain version (``kernels.ssd_scan.ref.ssd_chunked``, the reference's jnp
form) on the CPU.  The reference's ``mamba2_forward`` runs the jnp
``ssd_chunked``, the same function as its Pallas kernel; here the device
picks, as it does for the port's other kernels.  Decode is plain
PyTorch, as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import layers
from repro_torch.models.layers import Params, dense_init


class SSMConfig(NamedTuple):
    d_model: int
    d_state: int = 128          # N
    head_dim: int = 64          # P
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256
    n_groups: int = 1           # B/C groups (ngroups)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba2_init(generator: torch.Generator, cfg: SSMConfig,
                dtype: torch.dtype = torch.float32) -> Params:
    """Parameters with the reference's keys and shapes, in ``dtype`` but
    for ``dt_bias``, ``A_log`` and ``D``, which stay fp32 as the
    reference's do; meta tensors without a generator."""
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    g = cfg.n_groups
    d_in_proj = 2 * di + 2 * g * n + h     # z, x, B, C, dt
    conv_dim = di + 2 * g * n              # conv over x, B, C
    const = layers.const_device(generator)
    if generator is None:                  # shape only: nothing drawn
        dt_bias = torch.empty((h,), dtype=torch.float32, device=const)
    else:
        # dt bias initialised so that softplus(dt_bias) spans [1e-3, 1e-1]
        dt = torch.exp(torch.rand((h,), generator=generator,
                                  device=generator.device)
                       * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        dt_bias = dt + torch.log(-torch.expm1(-dt))
    return {
        "in_proj": dense_init(generator, cfg.d_model, d_in_proj, dtype),
        "conv_w": layers.trunc_normal(generator, (cfg.d_conv, conv_dim),
                                      std=1.0 / math.sqrt(cfg.d_conv),
                                      dtype=dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=const),
        "dt_bias": dt_bias.to(torch.float32),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=const)),
        "D": torch.ones((h,), device=const),
        "norm": layers.rmsnorm_init(di, dtype, const),
        "out_proj": dense_init(generator, di, cfg.d_model, dtype),
    }


def _split_in_proj(z_x_b_c_dt: torch.Tensor, cfg: SSMConfig):
    di, g, n = cfg.d_inner, cfg.n_groups, cfg.d_state
    z = z_x_b_c_dt[..., :di]
    xbc = z_x_b_c_dt[..., di:di + di + 2 * g * n]
    dt = z_x_b_c_dt[..., di + di + 2 * g * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, then SiLU.  xbc (B, L, C), w (K, C): the
    sum of K shifted products, as the reference writes it."""
    k, length = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + length, :] * w[i][None, None, :] for i in range(k))
    return F.silu(out + b[None, None, :])


def mamba2_forward(params: Params, x: torch.Tensor, cfg: SSMConfig,
                   init_state: Optional[torch.Tensor] = None):
    """x (B, L, D) -> (y (B, L, D), final SSM state (B, H, P, N)); the
    scan starts from ``init_state`` (B, H, P, N), or from zero."""
    b, l, _ = x.shape
    proj = layers.dense(params["in_proj"], x)
    z, xbc, dt = _split_in_proj(proj, cfg)
    xbc = _causal_conv(xbc, params["conv_w"].to(x.dtype),
                       params["conv_b"].to(x.dtype))
    di, g, n = cfg.d_inner, cfg.n_groups, cfg.d_state
    xs = xbc[..., :di].reshape(b, l, cfg.n_heads, cfg.head_dim)
    B = xbc[..., di:di + g * n].reshape(b, l, g, n)
    C = xbc[..., di + g * n:].reshape(b, l, g, n)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    y, final = ssd_scan(xs.to(torch.float32), dt, A, B.to(torch.float32),
                        C.to(torch.float32), chunk=min(cfg.chunk, l),
                        init_state=init_state)
    y = y + xs.to(torch.float32) * params["D"][None, None, :, None]
    y = y.reshape(b, l, di).to(x.dtype)
    y = layers.rmsnorm(params["norm"], y * F.silu(z))
    return layers.dense(params["out_proj"], y), final


class SSMCache(NamedTuple):
    conv_state: torch.Tensor   # (B, d_conv - 1, conv_dim)
    ssm_state: torch.Tensor    # (B, H, P, N) fp32
    length: torch.Tensor       # () int32


def ssm_cache_init(batch: int, cfg: SSMConfig,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> SSMCache:
    """An empty cache: the conv state in ``dtype``, the SSM state fp32."""
    conv_dim = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    return SSMCache(
        torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype,
                    device=device),
        torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                    dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def mamba2_decode_step(params: Params, x: torch.Tensor, cache: SSMCache,
                       cfg: SSMConfig) -> tuple[torch.Tensor, SSMCache]:
    """One-token decode.  x (B, 1, D) -> (y (B, 1, D), the updated cache)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"mamba2_decode_step takes one token, got {s}")
    proj = layers.dense(params["in_proj"], x)[:, 0]          # (B, d_in_proj)
    z, xbc, dt = _split_in_proj(proj, cfg)
    # the causal conv over the rolling state and the new row; a state and a
    # row of two dtypes meet in the wider, as JAX promotes them (an fp32
    # cache under bf16 activations: ServeLoop's)
    conv_in = torch.cat([cache.conv_state, xbc[:, None, :]], dim=1)  # (B, K, C)
    w = params["conv_w"].to(x.dtype)
    wide = torch.promote_types(conv_in.dtype, w.dtype)
    xbc = F.silu(torch.einsum("bkc,kc->bc", conv_in.to(wide), w.to(wide))
                 + params["conv_b"].to(x.dtype)[None, :])
    new_conv_state = conv_in[:, 1:, :]

    di, g, n = cfg.d_inner, cfg.n_groups, cfg.d_state
    xs = xbc[..., :di].reshape(b, cfg.n_heads, cfg.head_dim).to(torch.float32)
    B = xbc[..., di:di + g * n].reshape(b, g, n).to(torch.float32)
    C = xbc[..., di + g * n:].reshape(b, g, n).to(torch.float32)
    rep = cfg.n_heads // g
    B = torch.repeat_interleave(B, rep, dim=1)
    C = torch.repeat_interleave(C, rep, dim=1)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"][None, :])  # (B, H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A[None, :])                           # (B, H)
    state = (cache.ssm_state * dA[..., None, None]
             + (dt[..., None] * B)[:, :, None, :] * xs[..., None])
    y = torch.einsum("bhn,bhpn->bhp", C, state)
    y = y + xs * params["D"][None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    y = layers.rmsnorm(params["norm"], y * F.silu(z))
    out = layers.dense(params["out_proj"], y)[:, None, :]
    return out, SSMCache(new_conv_state, state, cache.length + 1)
