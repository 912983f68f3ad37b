"""The (dp, mp) mesh over torch.distributed ranks, and the batch and state
helpers of data parallelism (port of vm_asr_tpu/parallel/mesh.py).

Axes, as in the JAX package:
- ``dp``: data parallel. Each rank holds its rows of the global batch;
  parameters, buffers and optimizer state are the same on every rank, and
  the step averages the gradients over ``dp`` before the optimizer.
- ``mp``: the K cross-scan directions of every SS2D split over ranks
  (``parallel.context.set_activation_mesh``).

Rank ``r`` sits at ``(dp_rank, mp_rank) = divmod(r, mp)``, the JAX mesh's
``devices.reshape(dp, mp)``. The groups are made with ``new_group`` on the
default process group rather than by ``init_device_mesh``, which binds each
rank to a card of its own: the one-card harness puts two ranks on one card.

The backend is the caller's: ``init_process_group`` takes NCCL for ranks on
CUDA cards of their own, gloo for the CPU, and gloo for ranks that share one
card (gloo carries CUDA tensors for ``all_reduce`` and ``broadcast``). Nothing
here picks another backend when one fails.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.dist import process_rank, world_size


def init_distributed(rank: int, world: int, init_method: str, device, backend: Optional[str] = None
                     ) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` and return
    this rank's device. ``backend`` None: NCCL for a CUDA device, gloo for
    the CPU; pass ``"gloo"`` for ranks that share one card."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = dict(device_id=device) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            **kwargs)
    return device


@dataclass(frozen=True)
class Mesh:
    """A rank's place in the (dp, mp) mesh. ``dp_group`` holds the ranks of
    its ``mp`` index (None when dp is 1), ``mp_group`` those of its ``dp``
    index (None when mp is 1)."""

    dp: int
    mp: int
    rank: int = 0
    dp_group: Any = field(default=None, compare=False)
    mp_group: Any = field(default=None, compare=False)

    @property
    def dp_rank(self) -> int:
        return self.rank // self.mp

    @property
    def mp_rank(self) -> int:
        return self.rank % self.mp


def make_mesh(dp: int = -1, mp: int = 1) -> Mesh:
    """The (dp, mp) mesh over the default process group's ranks (one
    process and no group: a 1 × 1 mesh). ``dp = -1`` takes every rank on the
    data axis. Raises when dp·mp is not the number of ranks present, as the
    JAX package's reshape of too few devices does; every rank calls it, in
    the same order, since it makes the groups."""
    world = world_size()
    if dp == -1:
        if mp < 1 or world % mp:
            raise ValueError(f"mp={mp} does not divide the {world} rank(s) present")
        dp = world // mp
    if dp < 1 or mp < 1 or dp * mp != world:
        raise ValueError(
            f"a mesh of dp={dp} × mp={mp} needs {dp * mp} ranks; {world} present (start the "
            "ranks with `python -m vm_asr_tpu_torch.cli --opts MESH.DP n` or torchrun)")
    rank = process_rank()
    dp_group = mp_group = None
    # new_group is collective over the default group: every rank makes every group.
    for m in range(mp):
        ranks = [d * mp + m for d in range(dp)]
        g = dist.new_group(ranks) if dp > 1 else None
        if rank in ranks:
            dp_group = g
    for d in range(dp):
        ranks = [d * mp + m for m in range(mp)]
        g = dist.new_group(ranks) if mp > 1 else None
        if rank in ranks:
            mp_group = g
    return Mesh(dp, mp, rank, dp_group, mp_group)


def batch_rows(n: int, mesh: Mesh):
    """(start, count, total): the rows of an ``n``-row global batch this
    rank holds. A batch whose rows do not divide over dp is replicated
    (every rank holds all of it), as the JAX package's ``shard_batch``
    does."""
    if mesh.dp == 1 or n % mesh.dp:
        return 0, n, n
    count = n // mesh.dp
    return mesh.dp_rank * count, count, n


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch: every tensor or array with a
    leading axis is cut along it, and ``"rows"`` says which rows of the
    global batch these are, ``(start, total)`` (the steps draw their random
    masks for the global batch and keep these rows). Where the leading
    axis does not divide over dp, the whole batch is kept on every rank,
    with a warning: every rank then computes all of it."""
    sizes = {k: v.shape[0] for k, v in batch.items() if getattr(v, "ndim", 0) >= 1}
    n = next(iter(sizes.values()))
    if any(s != n for s in sizes.values()):
        raise ValueError(f"shard_batch: leading dims differ: {sizes}")
    start, count, total = batch_rows(n, mesh)
    if mesh.dp > 1 and count == total:
        logging.getLogger("vm_asr_tpu_torch").warning(
            "shard_batch: leading dim %d not divisible by dp=%d — replicating (wasteful; pad "
            "the batch to avoid)", n, mesh.dp)
    out = {k: (v[start:start + count] if k in sizes else v) for k, v in batch.items()}
    out["rows"] = (start, total)
    return out


def pad_batch_to(x: np.ndarray, multiple: int):
    """(x padded with zeros along its leading axis to a multiple of
    ``multiple``, its original length)."""
    b = x.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return x, b
    return np.pad(x, [(0, rem)] + [(0, 0)] * (x.ndim - 1)), b


def _tensors_of(state) -> List[torch.Tensor]:
    """A train state's tensors in a fixed order: the module's parameters and
    buffers, then the optimizer's per-parameter state and accumulator."""
    out = list(state.module.parameters()) + list(state.module.buffers())
    opt = state.optimizer
    for p in opt.params:
        # (AdamW's 0-dim ``step`` lives on the host and equals ``count``.)
        out += [v for _, v in sorted(opt.tx.state.get(p, {}).items())
                if isinstance(v, torch.Tensor) and v.dim() > 0]
    out += list(opt.acc or [])
    return out


def replicate_state(state) -> None:
    """Broadcast a ``GenState`` / ``DiscState`` from rank 0 to every rank,
    in place: parameters, buffers (the spectral-norm statistics) and the
    optimizer's state (the JAX package's ``replicate_tree``). The step
    count and schedule position are Python numbers every rank already
    shares."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in _tensors_of(state):
            dist.broadcast(t.data, src=0)
