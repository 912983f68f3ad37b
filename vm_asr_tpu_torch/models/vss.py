"""VSSBlock and VSSLayer (port of vm_asr_tpu/models/vss.py; reference
vmamba.py:1753-1843, model.py:889-958). Pre-norm blocks, eval path only."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .layers import Conv1x1, DropPath, LayerNorm, Mlp, PatchExpanding, PatchMerging
from .ss2d import SS2D


class VSSBlock(nn.Module):
    """x + DropPath(SS2D(LN(x))), then x + DropPath(MLP(LN(x)))."""

    def __init__(
        self,
        hidden_dim: int,
        drop_path: float = 0.0,
        use_norm: bool = True,  # the v3 head's identity-norm layers pass False
        ssm_d_state: int = 1,
        ssm_ratio: float = 2.0,
        ssm_dt_rank="auto",
        ssm_act: str = "silu",
        ssm_conv: int = 3,
        ssm_conv_bias: bool = True,
        mlp_ratio: float = 4.0,
        mlp_act: str = "gelu",
        *,
        compute_dtype: torch.dtype = torch.float32,
        scan_fp32_io: bool = False,
        scan_impl: str = "kernel",
    ):
        super().__init__()

        def norm():
            return LayerNorm(hidden_dim, compute_dtype=compute_dtype) if use_norm \
                else nn.Identity()

        self.ssm_branch = ssm_ratio > 0
        self.mlp_branch = mlp_ratio > 0
        if self.ssm_branch:
            self.norm = norm()
            self.op = SS2D(
                d_model=hidden_dim, d_state=ssm_d_state, ssm_ratio=ssm_ratio,
                dt_rank=ssm_dt_rank, act=ssm_act, d_conv=ssm_conv,
                conv_bias=ssm_conv_bias, compute_dtype=compute_dtype,
                scan_fp32_io=scan_fp32_io, scan_impl=scan_impl,
            )
        self.drop_path = DropPath(drop_path)
        if self.mlp_branch:
            self.norm2 = norm()
            self.mlp = Mlp(hidden_dim, int(hidden_dim * mlp_ratio), hidden_dim,
                           act=mlp_act, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ssm_branch:
            x = x + self.drop_path(self.op(self.norm(x)))
        if self.mlp_branch:
            x = x + self.drop_path(self.mlp(self.norm2(x)))
        return x


class VSSLayer(nn.Module):
    """skip_handler → VSSBlock × depth → sampler.

    sampler: None | ("merge", out_dim) | ("expand", use_norm).
    concat_skip: a 1×1 conv folding a concatenated skip (2C → C), held at
    ``skip_handler.1`` as in the reference."""

    def __init__(
        self,
        dim: int,
        drop_path: Sequence[float] = (),
        use_norm: bool = True,
        sampler: Optional[Tuple] = None,
        concat_skip: bool = False,
        *,
        compute_dtype: torch.dtype = torch.float32,
        **block_kwargs,
    ):
        super().__init__()
        self.skip_handler = nn.Sequential(
            nn.Identity(), Conv1x1(2 * dim, dim, compute_dtype=compute_dtype), nn.Identity()
        ) if concat_skip else None
        self.blocks = nn.ModuleList(
            VSSBlock(dim, float(dp), use_norm, compute_dtype=compute_dtype, **block_kwargs)
            for dp in drop_path
        )
        if sampler is None:
            self.sampler = None
        elif sampler[0] == "merge":
            self.sampler = PatchMerging(dim, sampler[1], compute_dtype=compute_dtype)
        elif sampler[0] == "expand":
            self.sampler = PatchExpanding(dim, sampler[1], compute_dtype=compute_dtype)
        else:
            raise ValueError(f"unknown sampler {sampler!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.skip_handler is not None:
            x = self.skip_handler[1](x)
        for block in self.blocks:
            x = block(x)
        return x if self.sampler is None else self.sampler(x)
