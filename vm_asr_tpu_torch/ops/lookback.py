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
epoch (1 to 2^30 − 1), so it is zeroed only when it is made and no kernel
clears it. The epoch is the device's: the workspace's first word holds the
last call's, each CTA reads it as it starts, and the CTA that takes the
call's last tile id stores the call's own; a call at the last epoch zeroes
the workspace as it ends. So a CUDA graph that captured a call gets a fresh
epoch on every replay, and the host picks none. One more word holds the
tile ticket: CTAs take tile ids in the order they ask, so the look-back
never waits on a CTA that is not resident, whatever else holds the card's
SMs.

A graph bakes in the workspace's address. So the workspace of a stream is
made, or grown, outside any capture (a capture that finds it missing or too
small raises: run the call once on the capture stream first), and a
workspace outgrown by a later call is kept, not freed, for as long as the
process lives: a graph may still replay on it. Calls and replays that use
one workspace must run one after another.
"""

from __future__ import annotations

import torch

_workspaces: dict = {}
_outgrown: list = []


def current_stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def lookback_workspace(device, stream: int, nbytes: int) -> torch.Tensor:
    """The look-back workspace of (``device``, ``stream``), at least
    ``nbytes`` long: zeroed when made, then the kernels' own."""
    key = (device, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < nbytes:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the scan's look-back workspace of stream {stream:#x} needs {nbytes} bytes "
                "inside a CUDA graph capture: run the call once on the capture stream first")
        if ws is not None:
            _outgrown.append(ws)
        ws = _workspaces[key] = torch.zeros(nbytes, dtype=torch.uint8, device=device)
    return ws


def lookback_work_bytes(slots: int, channels: int) -> int:
    """Bytes of the look-back's words for ``slots`` tiles of ``channels``
    channels: per channel the tile's P and S and its inclusive prefix, 8
    bytes each (the value and its epoch), after a header of two 128-byte
    lines (the last call's epoch, the count of CTAs done; the tile
    ticket)."""
    return 24 * slots * channels + 256


def lookback_smem(channels: int, window: int) -> int:
    """Shared memory of one CTA's look-back (scan_common.cuh:
    lookback_smem_bytes): the fp32 values of the W − 1 aggregates a tile
    reads at most, rounded up to 16 bytes."""
    return -(-(window - 1) * 2 * channels * 4 // 16) * 16
