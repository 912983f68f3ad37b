"""Process-wide parallel context (port of vm_asr_tpu/parallel/context.py).

The activation mesh: with a mesh whose ``mp`` axis is larger than 1
installed by ``set_activation_mesh``, every SS2D splits its K cross-scan
directions over ``mp`` (models/ss2d.py): each rank projects and scans its
K/mp directions, and one gather before ``cross_merge`` gives every rank the
whole output. ``set_activation_mesh(None)`` (or a mesh with mp 1) restores
the unsplit model.

The batch rows: under data parallelism a rank holds rows ``start ..
start + count`` of a global batch of ``total`` rows. The random masks of a
training forward (DropPath, dropout) and the penalty's interpolation
weights are drawn for the global batch, from the generator every rank
seeds alike, and each rank keeps its rows (``rand_rows``), so that the
ranks together draw what one process draws for the whole batch.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

_ACTIVE_MESH = None
_ROWS: Optional[Tuple[int, int]] = None


def set_activation_mesh(mesh) -> None:
    """Install (or clear, with None) the mesh the ``mp`` split reads."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_activation_mesh():
    return _ACTIVE_MESH


def mp_mesh():
    """The active mesh if its ``mp`` axis is larger than 1, else None."""
    m = _ACTIVE_MESH
    if m is not None and m.mp > 1:
        return m
    return None


@contextlib.contextmanager
def global_rows(start: int, total: int):
    """Within the block, a batch this process holds is rows ``start ..``
    of a global batch of ``total`` rows (``shard_batch``'s ``"rows"``)."""
    global _ROWS
    prev, _ROWS = _ROWS, (int(start), int(total))
    try:
        yield
    finally:
        _ROWS = prev


def rand_rows(shape, generator: torch.Generator, device) -> torch.Tensor:
    """``torch.rand(shape)`` for this process's rows of the global batch:
    drawn for all ``total`` rows and cut to ``shape[0]`` of them from
    ``start`` inside ``global_rows``; a plain draw outside it."""
    shape = tuple(shape)
    if _ROWS is None or _ROWS[1] == shape[0]:
        return torch.rand(shape, generator=generator, device=device)
    start, total = _ROWS
    if start + shape[0] > total:
        raise ValueError(f"rows {start}..{start + shape[0]} lie outside a global batch of "
                         f"{total}")
    return torch.rand((total,) + shape[1:], generator=generator,
                      device=device)[start:start + shape[0]]
