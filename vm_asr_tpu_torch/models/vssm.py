"""The VMamba image classifier and its multi-scale backbone (port of
vm_asr_tpu/models/vssm.py:27-125; reference vmamba.py:1846-2300).

    NHWC image → patch embed (4× down) → VSSLayer per stage, PatchMerging
    between stages → LayerNorm → mean over H, W → Linear head

``BackboneVSSM`` returns the tapped stages' outputs instead, NHWC, each
through a LayerNorm of its own. Neither is part of the speech model; they
share every building block with the U-Net. At the defaults (dims 96, depths
2-2-9-2, d_state 16) every SS2D has N = 16, so its scans take the general-N
route of ``ops/scan_api.py``: one recurrence launch per state channel.

Module names follow the JAX package's tree (``patch_embed``,
``stages.{i}``, ``norm``, ``head``, ``out_norms.{t}``), which
``compat/convert.py`` maps one to one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from .layers import LayerNorm, Linear, PatchEmbed
from .unet import resolve_dims
from .vss import VSSLayer


class VSSM(nn.Module):
    """``features(x)`` gives every stage's output (after its PatchMerging),
    ``forward(x)`` the logits. ``generator`` feeds the DropPath and dropout
    masks in training mode; the DropPath rates rise linearly from 0 to
    ``drop_path_rate`` over all blocks, cut per stage."""

    def __init__(
        self,
        num_classes: int = 1000,
        in_chans: int = 3,
        patch_size: int = 4,
        depths: Sequence[int] = (2, 2, 9, 2),
        dims=96,
        ssm_d_state: int = 16,
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
        drop_path_rate: float = 0.1,
        patch_norm: bool = True,
        patchembed_version: str = "v2",
        use_checkpoint: bool = False,
        *,
        compute_dtype: torch.dtype = torch.float32,
        scan_fp32_io: bool = False,
        scan_impl: str = "kernel",
    ):
        super().__init__()
        n = len(depths)
        self.dims = dims = resolve_dims(dims, n)
        dpr = list(np.linspace(0.0, drop_path_rate, sum(depths)))
        self.patch_embed = PatchEmbed(in_chans, dims[0], patch_size, patchembed_version,
                                      patch_norm, compute_dtype=compute_dtype)
        block_kwargs = dict(
            ssm_d_state=ssm_d_state, ssm_ratio=ssm_ratio, ssm_dt_rank=ssm_dt_rank,
            ssm_act=ssm_act, ssm_conv=ssm_conv, ssm_conv_bias=ssm_conv_bias,
            ssm_drop_rate=ssm_drop_rate, mlp_ratio=mlp_ratio, mlp_act=mlp_act,
            mlp_drop_rate=mlp_drop_rate, gmlp=gmlp, use_checkpoint=use_checkpoint,
            compute_dtype=compute_dtype, scan_fp32_io=scan_fp32_io, scan_impl=scan_impl)
        self.stages = nn.ModuleList(
            VSSLayer(dims[i], dpr[sum(depths[:i]):sum(depths[:i + 1])],
                     sampler=("merge", dims[i + 1]) if i < n - 1 else None, **block_kwargs)
            for i in range(n))
        self.norm = LayerNorm(dims[-1], compute_dtype=compute_dtype)
        self.head = Linear(dims[-1], num_classes, compute_dtype=compute_dtype)

    def features(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """Every stage's output, NHWC, from an NHWC image."""
        x = self.patch_embed(x)
        outs = []
        for stage in self.stages:
            x = stage(x, generator)
            outs.append(x)
        return outs

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x: (B, H, W, in_chans) → logits (B, num_classes)."""
        x = self.norm(self.features(x, generator)[-1])
        return self.head(x.mean(dim=(1, 2)))


class BackboneVSSM(VSSM):
    """The tapped stages' outputs (NHWC) with a LayerNorm per tap
    (reference vmamba.py:2244-2300); no classifier."""

    def __init__(self, out_indices: Sequence[int] = (0, 1, 2, 3), **kwargs):
        super().__init__(**kwargs)
        # No classifier: flax creates a submodule's parameters only where it
        # is called, and the reference's Backbone_VSSM deletes it.
        del self.norm, self.head
        n = len(self.stages)
        widths = [self.dims[i + 1] if i < n - 1 else self.dims[-1] for i in range(n)]
        self.out_indices = tuple(out_indices)
        compute_dtype = kwargs.get("compute_dtype", torch.float32)
        self.out_norms = nn.ModuleList(LayerNorm(widths[i], compute_dtype=compute_dtype)
                                       for i in self.out_indices)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, ...]:
        feats = self.features(x, generator)
        return tuple(norm(feats[i]) for i, norm in zip(self.out_indices, self.out_norms))
