"""Plain PyTorch versions of the Mamba-2 SSD scan.

The port of ``repro.models.ssm``'s ``_segsum``, ``ssd_chunked`` and
``ssd_reference``: the chunked dual form (the CPU path of
``ops.ssd_scan``, the function its backward differentiates, and the
yardstick the card holds the kernel to) and the O(L) recurrence (ground
truth in the tests).  ``ssd_scan_ref`` has the contract of the kernel's
wrapper.  The chunked form materialises (b, chunks, h, Q, Q) decay and
score tensors, which the kernel never writes.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{j < k <= i} x[..., k], and
    -inf above the diagonal."""
    t = x.shape[-1]
    x_cum = torch.cumsum(x, dim=-1)
    diff = x_cum[..., :, None] - x_cum[..., None, :]
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x (b, l, h, p); dt (b, l, h) positive; A (h,) negative; B, C
    (b, l, g, n) with g dividing h.  Returns (y (b, l, h, p), final state
    (b, h, p, n)).  A ragged length is zero-padded: dt = 0 rows are identity
    steps, so the final state is the unpadded sequence's.
    """
    y, final, _ = _chunked(x, dt, A, B, C, chunk, init_state)
    return y, final


def entering_states(x, dt, A, B, C, chunk: int, init_state=None):
    """(The state entering each chunk (b, ceil(l / chunk), h, p, n), the
    final state), as ``ssd_chunked`` computes them: the yardstick of the
    kernels' chunk-state scratch, which holds the former after a call."""
    _, final, entering = _chunked(x, dt, A, B, C, chunk, init_state)
    return entering, final


def _chunked(x, dt, A, B, C, chunk, init_state):
    """``ssd_chunked``'s body: (y, final state, the state entering each
    chunk)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        y, final, entering = _chunked(x, dt, A, B, C, chunk, init_state)
        return y[:, :l], final, entering
    nc = l // chunk
    rep = h // g

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = torch.repeat_interleave(B.reshape(b, nc, chunk, g, n), rep, dim=3)
    Cc = torch.repeat_interleave(C.reshape(b, nc, chunk, g, n), rep, dim=3)

    dA = dtc * A[None, None, None, :]                 # (b, nc, c, h) negative
    dA_cum = torch.cumsum(dA, dim=2)                  # within-chunk cumsum

    # 1) the diagonal (intra-chunk) block in its dual attention form
    L = torch.exp(_segsum(dA.transpose(2, 3)))        # (b, nc, h, c, c)
    G = torch.einsum("bzihn,bzjhn->bzhij", Cc, Bc)    # (b, nc, h, c, c)
    # the reference's three- and four-operand einsums, contracted pairwise
    # here: torch.einsum may otherwise form the (b, nc, c, h, n, p) outer
    # product (10 GB at the LM path's shape)
    M = G * L * dtc.transpose(2, 3)[:, :, :, None, :]
    y_diag = torch.einsum("bzhij,bzjhp->bzihp", M, xc)

    # 2) each chunk's own final state
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)   # (b, nc, c, h)
    states = torch.einsum("bzchn,bzchp->bzhpn",
                          Bc * (dtc * decay_to_end)[..., None],
                          xc)                                 # (b, nc, h, p, n)

    # 3) the inter-chunk recurrence, keeping the state entering each chunk
    chunk_decay = torch.exp(dA.sum(dim=2))                    # (b, nc, h)
    carry = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
             if init_state is None else init_state.to(x.dtype))
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)                    # (b, nc, h, p, n)

    # 4) the incoming state's contribution to each position
    state_decay = torch.exp(dA_cum)                           # (b, nc, c, h)
    y_off = (torch.einsum("bzchn,bzhpn->bzchp", Cc, prev_states)
             * state_decay[..., None])
    return (y_diag + y_off).reshape(b, l, h, p), carry, prev_states


def ssd_reference(x, dt, A, B, C) -> torch.Tensor:
    """The O(L) sequential recurrence: y (b, l, h, p)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bf = torch.repeat_interleave(B, rep, dim=2)
    Cf = torch.repeat_interleave(C, rep, dim=2)
    state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(l):
        dA = torch.exp(dt[:, t] * A)                          # (b, h)
        state = state * dA[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], Bf[:, t], x[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=1)


def ssd_scan_ref(x, dt, A, B, C, chunk: int, init_state=None):
    """The kernel's function in fp32: ``ssd_chunked`` at ``chunk`` on
    float32 copies of the inputs, from ``init_state`` (B, H, P, N) or
    zero: (y (B, L, H, P), final state (B, H, P, N))."""
    f32 = [t.to(torch.float32) for t in (x, dt, A, B, C)]
    if init_state is not None:
        init_state = init_state.to(torch.float32)
    return ssd_chunked(*f32, chunk=chunk, init_state=init_state)
