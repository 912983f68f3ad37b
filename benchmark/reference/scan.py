"""The selective scan in plain float32, (B, L, K, D) layout:

    dt_t = softplus(dts_t + dt_bias)
    h_t  = exp(dt_t · A) · h_{t-1} + dt_t · B_t · u_t
    y_t  = C_t · h_t + D · u_t

The recurrence is a Hillis–Steele doubling scan over (decay, increment)
pairs: log2(L) shifted multiply-adds; its gradient is the same scan run in
reverse.
``record`` (a list) receives (B, L, K·D, N) for every call, the shapes the
scan byte counter reads.
"""

from __future__ import annotations

from typing import List, Optional

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) + log1p(exp(-|x|)), with no threshold."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def doubling(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + b_t along ``dim``, h_{-1} = 0."""
    p, s, n, off = a, b, a.shape[dim], 1
    while off < n:
        p_tail = p.narrow(dim, off, n - off)
        s = torch.cat([s.narrow(dim, 0, off),
                       s.narrow(dim, off, n - off) + p_tail * s.narrow(dim, 0, n - off)], dim)
        p = torch.cat([p.narrow(dim, 0, off), p_tail * p.narrow(dim, 0, n - off)], dim)
        off *= 2
    return s


class _Recurrence(torch.autograd.Function):
    """The doubling scan with its adjoint written out, so that autograd
    keeps a and h and not every pass: with g = dL/dh,
    dL/db_t = g_t + a_{t+1} · dL/db_{t+1} (the same recurrence, reversed)
    and dL/da_t = dL/db_t · h_{t-1}."""

    @staticmethod
    def forward(ctx, a, b, dim):
        h = doubling(a, b, dim)
        ctx.save_for_backward(a, h)
        ctx.dim = dim
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        dim, n = ctx.dim, a.shape[ctx.dim]
        a_next = torch.cat([a.narrow(dim, 1, n - 1), torch.zeros_like(a.narrow(dim, 0, 1))], dim)
        db = doubling(a_next.flip(dim), g.flip(dim), dim).flip(dim)
        h_prev = torch.cat([torch.zeros_like(h.narrow(dim, 0, 1)), h.narrow(dim, 0, n - 1)], dim)
        return db * h_prev, db, None


def recurrence(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + b_t along ``dim``, h_{-1} = 0, differentiable."""
    return _Recurrence.apply(a, b, dim)


def selective_scan(u, dts, a_neg, bs, cs, d_skip, dt_bias,
                   record: Optional[List[tuple]] = None) -> torch.Tensor:
    """u, dts: (B, L, K, D); a_neg: (K, D, N); bs, cs: (B, L, K, N);
    d_skip, dt_bias: (K, D). Returns y (B, L, K, D) in float32."""
    b, l, k, d = u.shape
    n = a_neg.shape[-1]
    if record is not None:
        record.append((b, l, k * d, n))
    uf = u.float()
    dt = softplus(dts.float() + dt_bias.float()[None, None])
    if u.is_meta:  # counting shapes: the scan has no product and no value to give
        return dt * uf * d_skip.float()[None, None]
    y = d_skip.float()[None, None] * uf
    for i in range(n):
        a = torch.exp(dt * a_neg.float()[None, None, :, :, i])
        h = recurrence(a, dt * uf * bs[..., i:i + 1].float(), dim=1)
        y = y + h * cs[..., i:i + 1].float()
    return y
