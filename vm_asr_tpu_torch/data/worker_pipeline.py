"""Input pipeline on worker processes (the counterpart of
vm_asr_tpu/data/grain_pipeline.py, selected by ``DATA.PIPELINE grain``).

The same contract as the JAX package's ``GrainPipeline`` and the threads
``DataPipeline``: an epoch-aware iterable of fixed-shape ``Batch``es with
``len`` under ``drop_last``, ``set_epoch``, a per-host batch size, and
``shard_index`` / ``shard_count`` for input sharding across hosts. It is a
``torch.utils.data.DataLoader`` whose worker *processes* each build whole
batches, so the degradation (C++ and scipy) runs outside the parent's GIL.

Randomness is the threads pipeline's, not grain's (whose streams depend on
grain's internals): the epoch's order comes from ``default_rng(seed +
epoch)``, and the item at position p of the epoch draws from
``default_rng([base_seed, p])``. Shard s of k takes rows s·B .. s·B + B − 1
of each global batch of B·k items (``pipeline.epoch_shard``): item j of its
batch bi sits at position (bi·k + s)·B + j, disjoint across shards as long
as every host passes the same seed, and the shards of a global batch are
together the batch one process reads at batch B·k, bitwise. At
``shard_count`` 1 that is bi·B + j, so the batches are bitwise those of
``DataPipeline``, and so of the JAX package's ``DataPipeline``.

Workers are forked, and touch numpy and the host C++ library only (the
DataLoader's worker loop sets one torch thread each): no CUDA call is made
in a worker, so forking after the parent has initialised CUDA is safe;
``batch_to_device`` stays on the caller's thread. (Spawned workers would
start without the parent's imports and memoised items.) A worker's exception is raised in the consumer, and an
epoch left early shuts its workers down at once.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from .pipeline import (
    Batch,
    DegradingSampler,
    build_batch,
    check_shard,
    epoch_base_seed,
    epoch_order,
    epoch_shard,
    shard_len,
)


def _as_is(batch: Batch) -> Batch:
    return batch


class _EpochBatches(torch.utils.data.Dataset):
    """Batch bi of one epoch of one shard."""

    def __init__(self, sampler: DegradingSampler, batches: List[List[int]],
                 positions: List[List[int]], base_seed: int):
        self.sampler = sampler
        self.batches = batches
        self.positions = positions
        self.base_seed = base_seed

    def __len__(self) -> int:
        return len(self.batches)

    def __getitem__(self, bi: int) -> Batch:
        return build_batch(self.sampler, self.batches[bi], self.base_seed, self.positions[bi])


class WorkerPipeline:
    """Drop-in for DataPipeline on ``num_workers`` worker processes (0: in
    the caller's process)."""

    def __init__(self, sampler: DegradingSampler, batch_size: int,
                 indices: Optional[Sequence[int]] = None, shuffle: bool = True,
                 seed: int = 123, num_workers: int = 4, drop_last: bool = True,
                 prefetch: int = 2, shard_index: int = 0, shard_count: int = 1):
        """``batch_size`` is the per-host batch; ``prefetch`` the batches
        each worker builds ahead."""
        check_shard(shard_index, shard_count, drop_last)
        self.sampler = sampler
        self.batch_size = batch_size
        self.indices = list(indices if indices is not None else range(len(sampler.dataset)))
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._epoch = 0

    def __len__(self) -> int:
        return shard_len(len(self.indices), self.batch_size, self.shard_count, self.drop_last)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _epoch_batches(self) -> _EpochBatches:
        order = epoch_order(self.indices, self.shuffle, self.seed, self._epoch)
        members, positions = epoch_shard(order, self.batch_size, self.shard_index,
                                         self.shard_count, self.drop_last)
        return _EpochBatches(self.sampler, members, positions,
                             epoch_base_seed(self.seed, self._epoch))

    def __iter__(self) -> Iterator[Batch]:
        batches = self._epoch_batches()
        if self.num_workers == 0:
            for bi in range(len(batches)):
                yield batches[bi]
            return
        loader = torch.utils.data.DataLoader(
            batches, batch_size=None, shuffle=False, num_workers=self.num_workers,
            collate_fn=_as_is, prefetch_factor=self.prefetch, multiprocessing_context="fork")
        it = iter(loader)
        try:
            yield from it
        finally:
            # Left early, the iterator's workers would live until it is
            # collected; shut them down now.
            it._shutdown_workers()
