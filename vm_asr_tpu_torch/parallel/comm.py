"""Collectives with autograd, in one form that NCCL and gloo both take.

A gather is written as an ``all_reduce`` (sum) into zeroed slots: each rank
writes its piece into its own slot of a zero tensor and the sum leaves every
piece in place, exactly (x + 0 = x). gloo takes CUDA tensors for
``all_reduce`` and ``broadcast``, so the same code runs over NCCL, over gloo
on the CPU, and over gloo for ranks that share one card; the price is
``size`` times the bytes of a true all-gather, on the small tensors these
gathers move.

The autograd pairs of the ``mp`` split (Megatron's conjugate operators, on
the K axis of the cross-scan directions), for a loss that every rank of the
group computes alike:
- ``split(x)``: forward, this rank's slice; backward, the slices' gradients
  gathered, so that what feeds x gets its whole gradient on every rank;
- ``gather(x)``: forward, the slices gathered; backward, this rank's slice
  of the gradient, which every rank holds alike.
With both, every leaf's gradient is whole and equal on every rank of the
group, the K-sliced parameters' as much as the replicated ones'.

For a loss that differs over the group (each rank's share of a sequence),
``all_gather`` sums the gradients over the group in its backward, and
``all_reduce`` and ``sum_gradient`` are the sum's two halves.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def gather_slots(x: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` in its slot, on every rank."""
    out = x.new_zeros((size,) + tuple(x.shape))
    out[rank] = x
    dist.all_reduce(out, group=group)
    return out


def _group_rank(group):
    return dist.get_rank(group), dist.get_world_size(group)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        rank, size = _group_rank(group)
        ctx.dim, ctx.group = dim, group
        return x.chunk(size, dim=dim)[rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        rank, size = _group_rank(ctx.group)
        slots = gather_slots(g.contiguous(), ctx.group, rank, size)
        return torch.cat(slots.unbind(0), dim=ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        rank, size = _group_rank(group)
        ctx.dim, ctx.group = dim, group
        slots = gather_slots(x.contiguous(), group, rank, size)
        return torch.cat(slots.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        rank, size = _group_rank(ctx.group)
        return g.chunk(size, dim=ctx.dim)[rank].contiguous(), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        rank, size = _group_rank(group)
        ctx.group = group
        return gather_slots(x.contiguous(), group, rank, size)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[dist.get_rank(ctx.group)], None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (equal slices over the
    group); the backward gathers the slices' gradients."""
    return _Split.apply(x, dim, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's slices of ``x`` concatenated along ``dim``, in rank
    order; the backward keeps this rank's slice of the gradient."""
    return _Gather.apply(x, dim, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x``; the backward sums each slot's
    gradient over the group and returns this rank's."""
    return _AllGather.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group; the backward sums the gradient over
    the group too (each rank's ``x`` feeds every rank's sum)."""
    return _AllReduce.apply(x, group)


def sum_gradient(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; the backward sums its gradient over the group (a
    replicated input of a computation that each rank does a share of)."""
    return _SumGradient.apply(x, group)


@torch.no_grad()
def mean_(tensors, group, size: int) -> None:
    """Average ``tensors`` over the group in place, one ``all_reduce`` per
    dtype of one flat buffer."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= size
        for t, piece in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(piece.view_as(t))
