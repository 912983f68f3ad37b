"""The checkpointed look-back that the one-launch scan kernels share
(csrc/scan_common.cuh): its workspace, its shared memory, and a pure-Python
mirror of its rule.

The fused forward (csrc/fused_scan.cu) and the linear recurrence in both
directions (csrc/linear_recurrence.cu) cut each chain (a row and channel
group, walked in the scan's direction) into tiles j = 0 .. n-1 that run on
different CTAs. Tiles with (j + 1) % W == 0 are checkpoints and publish the
state leaving them; every other tile publishes its aggregate (P, S). The
state entering tile j is the aggregates of tiles c + 1 .. j - 1, composed in
that order, applied to checkpoint c = W·⌊j/W⌋ − 1's state (or to 0 when
c < 0): one fixed expression of the aggregates, so the kernels are bitwise
repeatable on any grid (tests/test_torch_lr_layout.py mirrors the rule in
Python).

The words live in one workspace per (device, stream), tagged with a per-call
epoch (1 to 2^30 − 1), so it is zeroed only when it is made or grown and no
kernel clears it. One more word holds the tile ticket: CTAs take tile ids in
the order they ask, so the look-back never waits on a CTA that is not
resident, whatever else holds the card's SMs.
"""

from __future__ import annotations

import torch

_EPOCHS = 1 << 30
_workspaces: dict = {}


def current_stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def lookback_workspace(device, stream: int, nbytes: int):
    """(bytes, epoch): the look-back workspace of (``device``, ``stream``), at
    least ``nbytes`` long, and a new epoch for one kernel call on it."""
    key = (device, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < nbytes or ws[1] + 1 >= _EPOCHS:
        ws = _workspaces[key] = [torch.zeros(nbytes, dtype=torch.uint8, device=device), 0]
    ws[1] += 1
    return ws[0], ws[1]


def lookback_work_bytes(slots: int, channels: int) -> int:
    """Bytes of the look-back's words for ``slots`` tiles of ``channels``
    channels: per channel the tile's P and S and its inclusive prefix, 8
    bytes each (the value and its epoch), and the 8-byte tile ticket."""
    return 24 * slots * channels + 8


def lookback_smem(channels: int, window: int) -> int:
    """Shared memory of one CTA's look-back (scan_common.cuh:
    lookback_smem_bytes): the fp32 values of the W − 1 aggregates a tile
    reads at most, rounded up to 16 bytes."""
    return -(-(window - 1) * 2 * channels * 4 // 16) * 16
