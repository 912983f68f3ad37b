"""4-directional cross-scan / cross-merge (port of vm_asr_tpu/ops/cross_scan.py).

Channels-last with the direction axis inside the channel dims:
``x: (B, H, W, C)`` → ``xs: (B, H*W, K=4, C)``. Directions:
  k=0: row-major (H then W)
  k=1: column-major (transpose H/W)
  k=2: row-major, reversed
  k=3: column-major, reversed
``cross_merge`` is the adjoint of ``cross_scan``: it maps each direction back
to row-major order and sums.
"""

from __future__ import annotations

import torch


def cross_scan(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, H*W, 4, C)."""
    b, h, w, c = x.shape
    row = x.reshape(b, h * w, c)
    col = x.transpose(1, 2).reshape(b, h * w, c)
    return torch.stack([row, col, row.flip(1), col.flip(1)], dim=2)


def cross_merge(ys: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H*W, 4, C) → (B, H*W, C): undo each direction's order and sum."""
    b, l, k, c = ys.shape
    if k != 4 or l != h * w:
        raise ValueError(f"expected (B, {h * w}, 4, C), got {tuple(ys.shape)}")
    fwd = ys[:, :, 0] + ys[:, :, 2].flip(1)
    swp = ys[:, :, 1] + ys[:, :, 3].flip(1)
    swp = swp.reshape(b, w, h, c).transpose(1, 2).reshape(b, l, c)
    return fwd + swp
