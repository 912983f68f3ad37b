"""This process's place among the ranks of a run: its rank and the number
of ranks in the default process group, 0 and 1 without one. The core
layer's rank-0 duties (logs, checkpoints, wandb, the corpus conversion)
read these; ``parallel/`` builds the mesh on them."""

from __future__ import annotations

import torch.distributed as dist


def process_rank() -> int:
    """This process's rank in the initialised default process group, else 0."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def world_size() -> int:
    """The default process group's size, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1
