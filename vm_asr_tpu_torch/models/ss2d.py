"""SS2D: the 2-D selective-scan block (port of vm_asr_tpu/models/ss2d.py).

    in_proj → (x, gate z) → depthwise 3×3 conv → SiLU
    → cross-scan into K=4 directional sequences
    → per-direction projections to (Δ, B, C)
    → selective scan (fp32 maths, CUDA kernels)
    → cross-merge → LayerNorm → · SiLU(z) → out_proj → dropout

Under an activation mesh with mp > 1 (``parallel.set_activation_mesh``),
each rank of an ``mp`` group keeps its K/mp directions after the cross-scan,
applies its slices of ``x_proj_weight``, ``dt_projs_weight``,
``dt_projs_bias``, ``A_logs`` and ``Ds``, scans them, and gathers ``y`` over
``mp`` before the cross-merge (the JAX package's shard_map over K). The
slicing (``parallel.split``) gathers its gradients in the backward, and the
gather (``parallel.gather``) keeps the rank's slice of its gradient, so that
every parameter's gradient, K-sliced or replicated, comes out whole and
alike on every rank of the group.

Parameters keep the reference's layouts: stacked-K ``x_proj_weight
(K, R+2N, D)``, ``dt_projs_weight (K, D, R)``, ``dt_projs_bias (K, D)``,
``A_logs (K·D, N)``, ``Ds (K·D,)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..ops import cross_merge, cross_scan, selective_scan
from ..parallel import gather, mp_mesh, split
from .layers import DepthwiseConv2d, Dropout, LayerNorm, Linear, get_activation, uniform_


def dt_bias_init_(t: torch.Tensor, generator: torch.Generator, dt_min: float = 0.001,
                  dt_max: float = 0.1, dt_init_floor: float = 1e-4) -> torch.Tensor:
    """softplus⁻¹ of dt ~ LogUniform(dt_min, dt_max), floored
    (vm_asr_tpu/models/ss2d.py:62-73)."""
    u = torch.rand(t.shape, generator=generator, dtype=torch.float32)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = torch.clamp_min(dt, dt_init_floor)
    with torch.no_grad():
        return t.copy_(dt + torch.log(-torch.expm1(-dt)))


def a_log_init_(t: torch.Tensor) -> torch.Tensor:
    """S4D-real: A = -(1..N) per channel, stored as log(1..N) along the last
    axis (vm_asr_tpu/models/ss2d.py:76-84)."""
    n = t.shape[-1]
    with torch.no_grad():
        return t.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand(t.shape))


class SS2D(nn.Module):
    def __init__(
        self,
        d_model: int,
        d_state: int = 1,
        ssm_ratio: float = 2.0,
        dt_rank="auto",
        act: str = "silu",
        d_conv: int = 3,
        conv_bias: bool = True,
        dropout: float = 0.0,
        bias: bool = False,
        dt_min: float = 0.001,
        dt_max: float = 0.1,
        dt_init_floor: float = 1e-4,
        k_group: int = 4,
        *,
        compute_dtype: torch.dtype = torch.float32,
        scan_fp32_io: bool = False,
        scan_impl: str = "kernel",
        checkpointed: bool = False,
    ):
        """``checkpointed``: the block runs as a selective activation
        checkpoint that keeps the scan's output (models/vss.py)."""
        super().__init__()
        d_inner = int(ssm_ratio * d_model)
        r = math.ceil(d_model / 16) if dt_rank == "auto" else int(dt_rank)
        self.d_inner, self.dt_rank, self.d_state, self.k_group = d_inner, r, d_state, k_group
        self.dt_init = (dt_min, dt_max, dt_init_floor)
        self.act = get_activation(act)
        self.scan_fp32_io = scan_fp32_io
        self.scan_impl = scan_impl
        self.checkpointed = checkpointed

        self.in_proj = Linear(d_model, 2 * d_inner, bias=bias, compute_dtype=compute_dtype)
        self.conv2d = DepthwiseConv2d(d_inner, d_conv, bias=conv_bias,
                                      compute_dtype=compute_dtype)
        self.x_proj_weight = nn.Parameter(torch.empty(k_group, r + 2 * d_state, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.empty(k_group, d_inner, r))
        self.dt_projs_bias = nn.Parameter(torch.empty(k_group, d_inner))
        self.A_logs = nn.Parameter(torch.empty(k_group * d_inner, d_state))
        self.Ds = nn.Parameter(torch.empty(k_group * d_inner))
        self.out_norm = LayerNorm(d_inner, compute_dtype=compute_dtype)
        self.out_proj = Linear(d_inner, d_model, bias=bias, compute_dtype=compute_dtype)
        self.dropout = Dropout(dropout)

    def init_from(self, generator: torch.Generator) -> None:
        """The parameters SS2D owns directly; its submodules init themselves."""
        uniform_(self.x_proj_weight, 1.0 / math.sqrt(self.d_inner), generator)
        uniform_(self.dt_projs_weight, self.dt_rank ** -0.5, generator)
        dt_bias_init_(self.dt_projs_bias, generator, *self.dt_init)
        a_log_init_(self.A_logs)
        nn.init.ones_(self.Ds)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` feeds the dropout mask in training mode."""
        b, h, w, _ = x.shape
        k, d, n, r = self.k_group, self.d_inner, self.d_state, self.dt_rank
        xs2d, z = self.in_proj(x).chunk(2, dim=-1)
        z = self.act(z)
        xs2d = self.act(self.conv2d(xs2d))

        xs = cross_scan(xs2d)  # (B, L, K, D)
        x_proj, dt_proj, dt_bias = self.x_proj_weight, self.dt_projs_weight, self.dt_projs_bias
        a_logs, ds = self.A_logs.reshape(k, d, n), self.Ds.reshape(k, d)
        mesh = mp_mesh()
        split_k = mesh is not None and k % mesh.mp == 0
        if split_k:
            group = mesh.mp_group
            xs, x_proj, dt_proj, dt_bias, a_logs, ds = (
                split(t, 0 if t.dim() < 4 else 2, group)
                for t in (xs, x_proj, dt_proj, dt_bias, a_logs, ds))
        x_dbl = torch.einsum("blkd,kcd->blkc", xs, x_proj.to(xs.dtype))
        dts, bs, cs = torch.split(x_dbl, [r, n, n], dim=-1)
        dts = torch.einsum("blkr,kdr->blkd", dts, dt_proj.to(dts.dtype))

        y = selective_scan(
            xs, dts, -torch.exp(a_logs.float()), bs, cs, ds, dt_bias,
            delta_softplus=True, fp32_io=self.scan_fp32_io, impl=self.scan_impl,
            checkpointed=self.checkpointed, lanes=k * d,
        )
        if split_k:
            y = gather(y, 2, mesh.mp_group)
        y = self.out_norm(cross_merge(y, h, w))
        y = y.reshape(b, h, w, d).to(x.dtype)
        return self.dropout(self.out_proj(y * z), generator)
