"""Plain reference of the VMamba classifier (Liu et al., "VMamba: Visual
State Space Model", NeurIPS 2024, arXiv:2401.10166; MzeroMiko/VMamba, the
"v0" tiny configuration classification/configs/vssm/vmambav0_tiny_224.yaml),
in float32 plain torch:

    uint8 image → (x − mean) / std (ImageNet's, VMamba's evaluation transform)
    → patch embed v1: conv 4×4 stride 4 → LN
    → stages: blocks x ← x + SS2D(LN(x)) (no MLP at MLP_RATIO 0), then, but
      for the last stage, the Swin 2×2 merge → LN(4C) → Linear(4C → 2C)
    → LN → mean over H, W → Linear head → logits

SS2D, PatchMerging, LayerNorm, Linear and Conv2d are the generator
reference's (``reference/generator.py``), and the selective scan is
``reference/scan.py``'s doubling scan, one recurrence per state channel.
Channels last (B, H, W, C); products at the precision of ``Products``. The
parameter names are the program's (``models/vssm.py``: ``patch_embed``,
``stages.{i}.blocks.{j}``, ``stages.{i}.sampler``, ``norm``, ``head``), so
one state dict serves both. ``Env.scan_record`` receives each scan call's
(B, L, K·D, N).

Departures from the published description:

- LayerNorm eps is 1e-5, torch's default, which the published code's
  ``nn.LayerNorm`` takes too.
- Evaluation only: DropPath (DROP_PATH_RATE 0.2) and dropout act in
  training and are left out.
- The images are already 224 × 224: the published evaluation's resize and
  centre crop have nothing to do.
- The scan's arithmetic is float32 throughout; the published v0 forward
  casts the scan's inputs to float32 too, and keeps the rest in the
  training precision.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .generator import SS2D, Conv2d, Env, LayerNorm, Linear, PatchMerging
from .precision import Products

# ImageNet's per-channel mean and std on the 0..255 scale.
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


def normalise(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 → float32, standardised per channel."""
    mean = torch.tensor(MEAN, device=images.device)
    std = torch.tensor(STD, device=images.device)
    return (images.float() - mean) / std


class Block(nn.Module):
    """x + SS2D(LN(x)): the VSS block with no MLP branch."""

    def __init__(self, env, dim, v):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.op = SS2D(env, dim, v["SSM_D_STATE"], v["SSM_RATIO"], v["SSM_DT_RANK"],
                       v["SSM_ACT_LAYER"], v["SSM_CONV"], v["SSM_CONV_BIAS"])

    def forward(self, x):
        return x + self.op(self.norm(x))


class Stage(nn.Module):
    def __init__(self, env, dim, depth, v, out_dim=None):
        super().__init__()
        self.blocks = nn.ModuleList(Block(env, dim, v) for _ in range(depth))
        self.sampler = PatchMerging(env, dim, out_dim) if out_dim else None

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x if self.sampler is None else self.sampler(x)


def _check(cfg: dict) -> None:
    v = cfg["MODEL"]["VSSM"]
    want = dict(PATCHEMBED="v1", DOWNSAMPLE="v1", MLP_RATIO=0.0, GMLP=False, PATCH_NORM=True,
                IN_CHANS=3)
    bad = {k: v.get(k) for k, x in want.items() if v.get(k, x) != x}
    if cfg["MODEL"]["TYPE"] != "vssm" or not isinstance(v["DIMS"], int) or bad:
        raise NotImplementedError(f"the reference classifier does not cover {bad or cfg['MODEL']}")


class VSSM(nn.Module):
    """The classifier of a configuration (the program's configuration dict)."""

    def __init__(self, cfg: dict, products: Products):
        super().__init__()
        _check(cfg)
        v = cfg["MODEL"]["VSSM"]
        self.env = Env(products)
        depths = list(v["DEPTHS"])
        n = len(depths)
        dims = [v["DIMS"] * 2 ** i for i in range(n)]
        p = v["PATCH_SIZE"]
        self.patch_embed = nn.Sequential(Conv2d(self.env, 3, dims[0], p, stride=p), nn.Identity(),
                                         LayerNorm(dims[0]))
        self.stages = nn.ModuleList(
            Stage(self.env, dims[i], depths[i], v, dims[i + 1] if i < n - 1 else None)
            for i in range(n))
        self.norm = LayerNorm(dims[-1])
        self.head = Linear(self.env, dims[-1], cfg["MODEL"]["NUM_CLASSES"])

    def network(self, x):
        """Normalised (B, H, W, 3) images → logits (B, classes)."""
        x = self.patch_embed[2](self.patch_embed[0](x))
        for stage in self.stages:
            x = stage(x)
        return self.head(self.norm(x).mean(dim=(1, 2)))

    def forward(self, images):
        """(B, H, W, 3) uint8 images → logits (B, classes), float32."""
        return self.network(normalise(images))


@torch.no_grad()
def logits(model: VSSM, images: torch.Tensor, rows: int = 8) -> torch.Tensor:
    """``model``'s logits of ``images``, ``rows`` images a forward: bounds
    the doubling scan's memory, not the result."""
    return torch.cat([model(chunk) for chunk in images.split(rows)])
