"""Seeded weights of the Jamba language model, drawn leaf by leaf on the
device from one generator (a 3 G-parameter model's leaves drawn at once
would take 24 GB), each leaf cast and then moved where the caller keeps
the state. The rules are the published initialiser's (transformers'
``JambaPreTrainedModel._init_weights`` at initializer_range 0.02) and
Mamba's Δ bias; the keys are the reference's, which are the program's.

- The embedding, every projection and the convolution's weight:
  N(0, 0.02²); the convolution's and any projection's bias: 0;
- ``dt_proj.bias``: softplus⁻¹(dt), dt log-uniform in [1e-3, 0.1], floored
  at 1e-4 (Mamba's ``dt_init``);
- ``A_log``: log(1..N) for every channel; ``D``: 1; RMSNorm weights: 1.

Matrices and vectors take ``dtype``; ``A_log``, ``D`` and Δ's bias stay
fp32, as the program keeps them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

FP32 = (".A_log", ".D", ".dt_proj.bias")
STD = 0.02


def _draw(key: str, shape, gen: torch.Generator, device) -> torch.Tensor:
    if key.endswith("dt_proj.bias"):
        lo, hi = math.log(1e-3), math.log(0.1)
        r = torch.rand(shape, generator=gen, device=device)
        dt = torch.exp(r * (hi - lo) + lo).clamp_min(1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    if key.endswith("A_log"):
        n = shape[-1]
        return torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device)).expand(
            shape).contiguous()
    if key.endswith(("layernorm.weight", ".D")):
        return torch.ones(shape, device=device)
    if key.endswith(".bias"):
        return torch.zeros(shape, device=device)
    return torch.randn(shape, generator=gen, device=device) * STD


@torch.no_grad()
def make_state(model: nn.Module, seed: int, device, dtype: torch.dtype,
               keep="cpu") -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` (any device, the meta device too), drawn
    from ``seed`` on ``device`` and kept on ``keep``."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    out = {}
    for key, t in model.state_dict().items():
        leaf = _draw(key, t.shape, gen, device)
        out[key] = leaf.to(torch.float32 if key.endswith(FP32) else dtype).to(keep)
    return out
