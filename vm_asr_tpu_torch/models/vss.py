"""VSSBlock and VSSLayer (port of vm_asr_tpu/models/vss.py; reference
vmamba.py:1753-1843, model.py:889-958). ``generator`` feeds the DropPath and
dropout masks in training mode (the JAX package's "dropout" rng)."""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.scan_api import SCAN_OUTPUT_OPS
from .layers import Conv1x1, DropPath, GMlp, LayerNorm, Mlp, PatchExpanding, PatchMerging
from .ss2d import SS2D


def _keep_scan_outputs(ctx, op, *args, **kwargs):
    """Selective checkpoint policy: keep the scans' outputs, recompute the
    rest (the JAX package's save_only_these_names("scan_out"))."""
    return CheckpointPolicy.MUST_SAVE if op in SCAN_OUTPUT_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


_SCAN_KEEPING_CONTEXTS = functools.partial(create_selective_checkpoint_contexts,
                                           _keep_scan_outputs)


class VSSBlock(nn.Module):
    """x + DropPath(SS2D(LN(x))), then x + DropPath(MLP(LN(x))).

    ``use_checkpoint``: under autograd the block runs as one activation
    checkpoint that keeps the scans' outputs and recomputes the rest in the
    backward (JAX: ``nn.remat`` with ``save_only_these_names("scan_out")``).
    Its scans then take the dispatcher-op route whose outputs the policy can
    name (``SS2D(checkpointed=True)``); other blocks keep the cheaper
    autograd Functions.
    The recompute draws the same DropPath and dropout masks: it starts from
    a copy of the generator's state at the block's entry, and the caller's
    generator leaves the block where the first run left it."""

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
        ssm_drop_rate: float = 0.0,
        mlp_ratio: float = 4.0,
        mlp_act: str = "gelu",
        mlp_drop_rate: float = 0.0,
        gmlp: bool = False,
        use_checkpoint: bool = False,
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
        self.use_checkpoint = use_checkpoint
        if self.ssm_branch:
            self.norm = norm()
            self.op = SS2D(
                d_model=hidden_dim, d_state=ssm_d_state, ssm_ratio=ssm_ratio,
                dt_rank=ssm_dt_rank, act=ssm_act, d_conv=ssm_conv,
                conv_bias=ssm_conv_bias, dropout=ssm_drop_rate, compute_dtype=compute_dtype,
                scan_fp32_io=scan_fp32_io, scan_impl=scan_impl, checkpointed=use_checkpoint,
            )
        self.drop_path = DropPath(drop_path)
        if self.mlp_branch:
            self.norm2 = norm()
            self.mlp = (GMlp if gmlp else Mlp)(
                hidden_dim, int(hidden_dim * mlp_ratio), hidden_dim, act=mlp_act,
                drop_rate=mlp_drop_rate, compute_dtype=compute_dtype)

    def _body(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.ssm_branch:
            x = x + self.drop_path(self.op(self.norm(x), generator), generator)
        if self.mlp_branch:
            x = x + self.drop_path(self.mlp(self.norm2(x), generator), generator)
        return x

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if not (self.use_checkpoint and torch.is_grad_enabled()):
            return self._body(x, generator)
        if generator is None:
            return checkpoint(self._body, x, None, use_reentrant=False,
                              context_fn=_SCAN_KEEPING_CONTEXTS)
        # torch's checkpoint restores the global RNGs for the recompute, not
        # an explicit generator: each run draws from its own copy of the
        # entry state instead, and the caller's generator moves on as the
        # first run's copy did.
        entry, after = generator.get_state(), []

        def run(v):
            g = torch.Generator(device=generator.device)
            g.set_state(entry)
            out = self._body(v, g)
            if not after:
                after.append(g.get_state())
            return out

        out = checkpoint(run, x, use_reentrant=False, context_fn=_SCAN_KEEPING_CONTEXTS)
        generator.set_state(after[0])
        return out


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

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self.skip_handler is not None:
            x = self.skip_handler[1](x)
        for block in self.blocks:
            x = block(x, generator)
        return x if self.sampler is None else self.sampler(x)
