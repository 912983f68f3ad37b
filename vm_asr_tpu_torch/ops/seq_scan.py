"""Sequence-sharded selective scan over ranks (port of
vm_asr_tpu/ops/seq_scan.py): each rank scans its L-shard with zero initial
state, the shards' summaries are exchanged with one gather over the group,
and a per-position correction applies the state entering the shard:

    h_t(global) = h_t(local) + (Π_{r≤t in shard} a_r) · h_offset(shard)
    h_offset(m) = Σ_{s<m} h_final(s) · Π_{s<r<m} P(r),   P(r) = Π a over shard r

The shard's scan is the port's ``selective_scan``, so the fused CUDA kernel
and its backward kernel run on each shard (K·D ≥ 128); the summaries are
closed forms in torch, differentiable through plain autograd:

    h_fin = Σ_t exp(logp − logcum_t) · Δ_t B_t u_t,   logcum_t = Σ_{r≤t} Δ_r·A

where every exponent is Σ_{r>t} Δ_r·A ≤ 0. The only traffic is the
(n_shards, B, K·D) summaries (``parallel.all_gather``, which sums their
gradients over the group in the backward).

N = 1 (the production d_state) only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel import all_gather, sum_gradient
from .scan_api import selective_scan
from .selective_scan_ref import softplus


def seq_sharded_selective_scan(
    u: torch.Tensor,        # (B, Ls, K, D): this rank's shard of L
    dts: torch.Tensor,      # (B, Ls, K, D)
    A: torch.Tensor,        # (K, D, 1)
    Bs: torch.Tensor,       # (B, Ls, K, 1)
    Cs: torch.Tensor,       # (B, Ls, K, 1)
    D_skip: torch.Tensor,   # (K, D)
    dt_bias: torch.Tensor,  # (K, D)
    group=None,
) -> torch.Tensor:
    """y for this rank's shard, (B, Ls, K, D) in u's dtype. The group's rank
    i holds positions [i·Ls, (i + 1)·Ls) of the sequence (every shard the
    same length). A, D_skip and dt_bias are the same on every rank; their
    gradients come out summed over the group (the whole sequence's), the
    shards' inputs' gradients are each shard's own."""
    if A.shape[-1] != 1:
        raise ValueError("sequence sharding implements the N = 1 scan")
    me, n_sh = dist.get_rank(group), dist.get_world_size(group)
    b, ls, k, d = u.shape
    A, D_skip, dt_bias = (sum_gradient(t, group) for t in (A, D_skip, dt_bias))
    y = selective_scan(u, dts, A, Bs, Cs, D_skip, dt_bias, delta_softplus=True).float()

    dt = softplus(dts.float() + dt_bias.float()[None, None])
    a_log = dt * A.float()[None, None, :, :, 0]                 # (B, Ls, K, D) ≤ 0
    bmat = dt * u.float() * Bs[..., 0].float()[:, :, :, None]
    logcum = torch.cumsum(a_log, dim=1)
    logp = logcum[:, -1:]                                        # the shard's log-decay
    h_fin = torch.sum(torch.exp(logp - logcum) * bmat, dim=1)   # (B, K, D)

    all_fin = all_gather(h_fin.reshape(b, k * d), group)        # (n_sh, B, KD)
    all_logp = all_gather(logp.reshape(b, k * d), group)
    cums = torch.cumsum(all_logp, dim=0)                         # inclusive over shards
    upto_prev = cums[me - 1] if me > 0 else torch.zeros_like(cums[0])
    # Mask before the exponential: on shards s >= me the exponent is
    # positive and grows with the shard's length, so exp() overflows to inf
    # at Ls ≳ 1k; a mask after it would leave inf·0 = NaN in the backward.
    mask = (torch.arange(n_sh, device=u.device) < me)[:, None, None]
    exponent = torch.where(mask, upto_prev[None] - cums, torch.full_like(cums, -torch.inf))
    h_off = torch.sum(all_fin * torch.exp(exponent), dim=0).reshape(b, 1, k, d)

    y = y + torch.exp(logcum) * h_off * Cs[..., 0].float()[:, :, :, None]
    return y.to(u.dtype)
