"""Plain-torch selective scan: the specification the CUDA kernels are held to.

Port of vm_asr_tpu/ops/selective_scan_ref.py:

    dt_t = softplus(delta_t + delta_bias)             [optional]
    h_t  = exp(dt_t · A) * h_{t-1} + dt_t · B_t · u_t
    y_t  = C_t · h_t + D · u_t

The recurrence is a Hillis–Steele doubling scan over (decay, increment)
pairs with the composition ``(a2, b2) ∘ (a1, b1) = (a2·a1, a2·b1 + b2)``:
log2(L) full-size passes, each a shifted multiply-add. Products of decays
only ever multiply, so they underflow harmlessly to 0; a closed form built on
``cumprod(a)`` and a division would not survive L = 262 144.
"""

from __future__ import annotations

from typing import Optional

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: max(x, 0) + log1p(exp(-|x|)), with no threshold
    (``torch.nn.functional.softplus`` returns x itself above 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def linear_recurrence_ref(a: torch.Tensor, b: torch.Tensor, dim: int = -2
                          ) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t (h_{-1} = 0) along ``dim``."""
    p, s = a, b
    n = a.shape[dim]
    off = 1
    while off < n:
        head_s, head_p = s.narrow(dim, 0, off), p.narrow(dim, 0, off)
        p_tail = p.narrow(dim, off, n - off)
        s = torch.cat(
            [head_s, s.narrow(dim, off, n - off) + p_tail * s.narrow(dim, 0, n - off)],
            dim,
        )
        p = torch.cat([head_p, p_tail * p.narrow(dim, 0, n - off)], dim)
        off *= 2
    return s


def selective_scan_ref(
    u: torch.Tensor,            # (B, G*D, L)
    delta: torch.Tensor,        # (B, G*D, L)
    A: torch.Tensor,            # (G*D, N)
    Bmat: torch.Tensor,         # (B, G, N, L)
    Cmat: torch.Tensor,         # (B, G, N, L)
    D: Optional[torch.Tensor] = None,           # (G*D,)
    delta_bias: Optional[torch.Tensor] = None,  # (G*D,)
    delta_softplus: bool = False,
    return_last_state: bool = False,
):
    """Reference-shaped selective scan; fp32 maths, output in u's dtype."""
    inp_dtype = u.dtype
    b, gd, l = u.shape
    _, g, n, _ = Bmat.shape
    d = gd // g

    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()[None, :, None]
    if delta_softplus:
        dt = softplus(dt)

    uf = u.float().reshape(b, g, d, l)
    dt = dt.reshape(b, g, d, l)
    Af = A.float().reshape(g, d, n)
    Bf = Bmat.float()
    Cf = Cmat.float()

    a = torch.exp(dt[..., None] * Af[None, :, :, None, :])      # (B, G, D, L, N)
    inc = (dt * uf)[..., None] * Bf.transpose(-1, -2)[:, :, None]
    h = linear_recurrence_ref(a, inc, dim=-2)

    y = torch.sum(h * Cf.transpose(-1, -2)[:, :, None], dim=-1)
    if D is not None:
        y = y + D.float().reshape(1, g, d, 1) * uf
    y = y.reshape(b, gd, l).to(inp_dtype)
    if return_last_state:
        return y, h[..., -1, :].reshape(b, gd, n)
    return y
