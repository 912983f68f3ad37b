"""Seeded weights, made on the device in two draws: one uniform and one
normal tensor as long as all the leaves together, cut into the leaves and
scaled by each leaf's rule. The rules follow the published initialisation
(VMamba's and HiFi-GAN's), so that activations have their trained model's
scale; the keys are the reference's, which are the program's.

- Linear weights: std 0.02 (uniform of that std), biases 0;
- convolutions (patch embedding, depthwise, 1×1 skip and head convs, the
  discriminator's): weight and bias U(±1/√fan_in);
- SS2D: x_proj U(±1/√d_inner), dt_proj U(±dt_rank^-½), dt bias the inverse
  softplus of dt log-uniform in [1e-3, 0.1] floored at 1e-4, A_logs log(1..N),
  D ones; LayerNorm ones and zeros;
- spectral norm: u ~ N(0, 1), sigma 1.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from .reference import generator as G
from .reference import mpd as M


def _rule(module: nn.Module, name: str, leaf: torch.Tensor):
    """(kind, scale) for one leaf: kind "u" (uniform ±scale), "n" (normal ×
    scale), or a fixed fill."""
    if isinstance(module, nn.LayerNorm):
        return ("one" if name == "weight" else "zero"), 0.0
    if isinstance(module, G.Linear):
        return ("u", 0.02 * math.sqrt(3.0)) if name == "weight" else ("zero", 0.0)
    if isinstance(module, (G.Conv2d, G.Conv1x1, M.SNConv2d)):
        if name == "u":
            return "n", 1.0
        if name == "sigma":
            return "one", 0.0
        return "u", 1.0 / math.sqrt(module.weight[0].numel())
    if isinstance(module, G.SS2D):
        return {"x_proj_weight": ("u", 1.0 / math.sqrt(module.d)),
                "dt_projs_weight": ("u", module.r ** -0.5),
                "dt_projs_bias": ("dt", 0.0), "A_logs": ("alog", 0.0),
                "Ds": ("one", 0.0)}[name]
    raise KeyError(f"no rule for {type(module).__name__}.{name}")


@torch.no_grad()
def make_state(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` (any device, the meta device too) drawn
    from ``seed`` on ``device``."""
    leaves = []
    for mname, module in model.named_modules():
        for name, t in list(module.named_parameters(recurse=False)) + \
                list(module.named_buffers(recurse=False)):
            leaves.append((f"{mname}.{name}" if mname else name, t.shape,
                           _rule(module, name, t)))
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    uni = torch.rand(total, generator=gen, device=device) * 2 - 1
    nor = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for key, shape, (kind, scale) in leaves:
        n = math.prod(shape)
        u, z = uni[at:at + n].reshape(shape), nor[at:at + n].reshape(shape)
        at += n
        if kind == "u":
            t = u * scale
        elif kind == "n":
            t = z * scale
        elif kind == "one":
            t = torch.ones(shape, device=device)
        elif kind == "zero":
            t = torch.zeros(shape, device=device)
        elif kind == "dt":
            lo, hi = math.log(1e-3), math.log(0.1)
            dt = torch.clamp_min(torch.exp((u + 1) / 2 * (hi - lo) + lo), 1e-4)
            t = dt + torch.log(-torch.expm1(-dt))
        else:  # "alog"
            t = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                       device=device)).expand(shape)
        out[key] = t.contiguous()
    return out
