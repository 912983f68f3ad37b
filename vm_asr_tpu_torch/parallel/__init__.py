"""Multi-device training over torch.distributed (port of
vm_asr_tpu/parallel/): the (dp, mp) mesh, batch sharding, state
replication, collectives with autograd, and the activation mesh of the
``mp`` split."""

from .comm import all_gather, all_reduce, gather, mean_, split, sum_gradient
from .context import get_activation_mesh, global_rows, mp_mesh, rand_rows, set_activation_mesh
from .mesh import (
    Mesh,
    batch_rows,
    init_distributed,
    make_mesh,
    pad_batch_to,
    process_rank,
    replicate_state,
    shard_batch,
    world_size,
)

__all__ = [
    "Mesh",
    "all_gather",
    "all_reduce",
    "batch_rows",
    "gather",
    "get_activation_mesh",
    "global_rows",
    "init_distributed",
    "make_mesh",
    "mean_",
    "mp_mesh",
    "pad_batch_to",
    "process_rank",
    "rand_rows",
    "replicate_state",
    "set_activation_mesh",
    "shard_batch",
    "split",
    "sum_gradient",
    "world_size",
]
