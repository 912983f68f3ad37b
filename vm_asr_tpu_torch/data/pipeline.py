"""Host input pipeline: fixed-shape batches with degradation on the fly
(port of vm_asr_tpu/data/pipeline.py; reference data_loader/data_loaders.py:
25-79 for the loader factory and 90/10 random split, 349-520 for load, pad
and random-rate degradation).

- All randomness (the input rate, the filter, the padding noise) is drawn on
  the host from numpy ``Generator``s, as the reference draws it in its
  DataLoader workers. Item j of batch bi draws from
  ``default_rng([base_seed, bi·B + j])``, and an epoch's order from
  ``default_rng(seed + epoch)``, so batches are bitwise the JAX package's.
- Under data parallelism each rank reads its share of every global batch
  (``shard_index`` = its rank, ``shard_count`` = dp, ``batch_size`` the
  per-rank batch B): global batch bi holds positions bi·B·k .. (bi+1)·B·k − 1
  of the epoch's order, the same items a single process reads at batch B·k,
  and rank s takes its rows s·B .. s·B + B − 1 (``epoch_shard``). An item's
  randomness is keyed by its position in the epoch, so the shards together
  are bitwise the one process's batch.
- Every training batch has the same shape (SEGMENT seconds at TARGET_SR).
- A thread pool overlaps the degradation (the host C++ library, scipy for
  what it does not take) with the device's work. The threads touch numpy
  only: ``batch_to_device`` runs on the caller's thread, so no CUDA call is
  made from a pipeline thread. ``DATA.PIPELINE grain`` takes the
  worker-process pipeline instead (``worker_pipeline.py``), with the same
  batches.
- ``get_loaders`` converts the raw VCTK 0.92 FLAC tree to the trimmed wav
  tree when only the former is on disk (``ensure_wav_tree``).
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dsp.audio import resample_audio
from ..dsp.degrade import degrade
from ..core.dist import process_rank


@dataclass
class Batch:
    wave_input: np.ndarray   # (B, 1, T) float32
    wave_target: np.ndarray  # (B, 1, T) float32
    highcut: np.ndarray      # (B,) int32
    names: List[str]
    pad_lengths: np.ndarray  # (B,) int32


def batch_to_device(batch: Batch, device) -> Dict[str, torch.Tensor]:
    """{"wave_input", "wave_target", "highcut"} on ``device``: copied from
    pinned host memory without blocking when the device is a card, highcut
    as int64 (the counterpart of the JAX package's ``shard_batch``)."""
    device = torch.device(device)
    out = {}
    for key, arr, dtype in (("wave_input", batch.wave_input, torch.float32),
                            ("wave_target", batch.wave_target, torch.float32),
                            ("highcut", batch.highcut, torch.int64)):
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
        if device.type == "cuda":
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=True)
    return out


class DegradingSampler:
    """Turns dataset items into fixed-length (input, target, highcut) tuples."""

    def __init__(self, dataset, config, training: bool = True,
                 input_sr: Optional[int] = None):
        self.dataset = dataset
        self.config = config
        self.training = training
        self.input_sr = input_sr
        d = config.DATA
        self.target_sr = d.TARGET_SR
        self.num_frames = int(d.SEGMENT * self.target_sr)
        self.pad_eps = d.PAD_WHITENOISE
        self.n_fft = d.STFT.N_FFT
        self.filters = [tuple(f) for f in (d.LPF.LPF_TRAIN if training else d.LPF.LPF_TEST)]
        self.random_resample = list(d.RANDOM_RESAMPLE)
        self.weighted = d.WEIGHTED_SR

    def _draw_input_sr(self, rng: np.random.Generator) -> int:
        if self.input_sr is not None:
            return self.input_sr
        if len(self.random_resample) == 1:
            return int(self.random_resample[0])
        if self.weighted.ENABLE:
            # Lower rates drawn more often (reference data_loaders.py:440-447).
            ridx = rng.choice(len(self.weighted.RANGES), p=self.weighted.WEIGHTS)
            lo, hi = self.weighted.RANGES[ridx]
        else:
            lo, hi = self.random_resample[0], self.random_resample[-1]
        return int(rng.integers(lo, hi + 1))

    def _fit_length(self, audio: np.ndarray, rng: np.random.Generator
                    ) -> Tuple[np.ndarray, int]:
        """Train: crop or pad with white noise to exactly one segment. Eval:
        pad to a segment multiple and keep the whole clip, which the Tester
        cuts with unfold/fold (reference data_loaders.py:371-389,
        tester.py:106-140)."""
        n = self.num_frames
        t = audio.shape[-1]
        if self.training and t > n:
            return audio[:n], 0
        pad = n - t if self.training else (n - t % n) % n
        if pad:
            noise = rng.standard_normal(pad).astype(np.float32) * self.pad_eps
            audio = np.concatenate([audio, noise], axis=-1)
        return audio, pad

    def sample(self, index: int, rng: np.random.Generator):
        audio, sr, name = self.dataset.load(index)
        if sr != self.target_sr:
            audio = resample_audio(audio, sr, self.target_sr)
        audio, pad = self._fit_length(audio.astype(np.float32), rng)

        sr_in = self._draw_input_sr(rng)
        filt = self.filters[rng.integers(len(self.filters))]
        x, highcut = degrade(audio, self.target_sr, sr_in, filt, self.n_fft)
        return x, audio, highcut, name, pad


def build_batch(sampler: DegradingSampler, members: Sequence[int], base_seed: int,
                positions: Sequence[int]) -> Batch:
    """The batch of corpus items ``members``: item j draws its randomness
    from ``default_rng([base_seed, positions[j]])``, its position in the
    epoch."""
    outs = [sampler.sample(index, np.random.default_rng([base_seed, pos]))
            for index, pos in zip(members, positions)]
    xs, ys, hcs, names, pads = zip(*outs)
    return Batch(
        wave_input=np.stack(xs)[:, None, :],
        wave_target=np.stack(ys)[:, None, :],
        highcut=np.asarray(hcs, np.int32),
        names=list(names),
        pad_lengths=np.asarray(pads, np.int32),
    )


def epoch_order(indices: Sequence[int], shuffle: bool, seed: int, epoch: int) -> List[int]:
    """An epoch's order of ``indices``: shuffled by ``default_rng(seed +
    epoch)`` when ``shuffle``."""
    idx = list(indices)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(idx)
    return idx


def epoch_base_seed(seed: int, epoch: int) -> int:
    """The first word of every item's seed in an epoch."""
    return (seed * 1_000_003 + epoch) % (2**31)


def check_shard(shard_index: int, shard_count: int, drop_last: bool) -> None:
    if not 0 <= shard_index < shard_count:
        raise ValueError(f"shard_index {shard_index} not in [0, {shard_count})")
    if shard_count > 1 and not drop_last:
        raise ValueError("a sharded pipeline drops the last partial global batch: "
                         "drop_last must be True")


def shard_len(n: int, batch_size: int, shard_count: int, drop_last: bool) -> int:
    """Batches of one shard in an epoch of ``n`` items (one per global batch)."""
    g = batch_size * shard_count
    return n // g if drop_last else -(-n // g)


def epoch_shard(order: Sequence[int], batch_size: int, shard_index: int, shard_count: int,
                drop_last: bool) -> Tuple[List[List[int]], List[List[int]]]:
    """(members, positions) of each of one shard's batches in an epoch of
    ``order``: rows ``shard_index·B ..`` of each global batch of B·k items."""
    b, g = batch_size, batch_size * shard_count
    members, positions = [], []
    for bi in range(shard_len(len(order), b, shard_count, drop_last)):
        lo = bi * g + shard_index * b
        pos = list(range(lo, min(lo + b, len(order))))
        members.append([order[p] for p in pos])
        positions.append(pos)
    return members, positions


class DataPipeline:
    """Shuffled, threaded, fixed-shape batch iterator."""

    def __init__(self, sampler: DegradingSampler, batch_size: int,
                 indices: Optional[Sequence[int]] = None, shuffle: bool = True,
                 seed: int = 123, num_workers: int = 4, drop_last: bool = True,
                 prefetch: int = 2, shard_index: int = 0, shard_count: int = 1):
        """``batch_size``: this shard's batch; ``shard_index`` /
        ``shard_count``: its share of each global batch (module docstring)."""
        check_shard(shard_index, shard_count, drop_last)
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.sampler = sampler
        self.batch_size = batch_size
        self.indices = list(indices if indices is not None else range(len(sampler.dataset)))
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        return shard_len(len(self.indices), self.batch_size, self.shard_count, self.drop_last)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self) -> Iterator[Batch]:
        idx = epoch_order(self.indices, self.shuffle, self.seed, self._epoch)
        batches, positions = epoch_shard(idx, self.batch_size, self.shard_index,
                                         self.shard_count, self.drop_last)
        base_seed = epoch_base_seed(self.seed, self._epoch)

        def make_batch(bi: int, members: List[int]) -> Batch:
            return build_batch(self.sampler, members, base_seed, positions[bi])

        # At most num_workers + prefetch batches are submitted and not yet
        # handed over: one more is submitted as each is yielded, so a long
        # epoch holds a bounded number of batches in host memory. A worker's
        # exception is raised here, by its future, in the consumer's thread.
        window = self.num_workers + self.prefetch
        pending: "deque[Future]" = deque()
        with ThreadPoolExecutor(self.num_workers) as pool:
            try:
                for bi, members in enumerate(batches):
                    if len(pending) == window:
                        yield pending.popleft().result()
                    pending.append(pool.submit(make_batch, bi, members))
                while pending:
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()


def train_valid_split(n: int, valid_split: float, seed: int = 42
                      ) -> Tuple[List[int], List[int]]:
    """The 90/10 random split with a fixed generator
    (reference data_loaders.py:31-38, torch.random_split(seed=42))."""
    perm = np.random.default_rng(seed).permutation(n)
    n_valid = int(n * valid_split)
    return list(perm[n_valid:]), list(perm[:n_valid])


def ensure_wav_tree(config, logger=None) -> str:
    """The trimmed wav tree DATA_PATH/FLAC2WAV.DST_PATH, converted from
    DATA_PATH/VCTK-Corpus-0.92/wav48_silence_trimmed when it is missing
    (reference data_loaders.py:95-103). Rank 0 converts and then writes
    ``<root>.converted``; the other ranks wait for that marker."""
    root = f"{config.DATA.DATA_PATH.rstrip('/')}/{config.DATA.FLAC2WAV.DST_PATH}"
    if os.path.isdir(root):
        return root
    flac_root = os.path.join(config.DATA.DATA_PATH, "VCTK-Corpus-0.92", "wav48_silence_trimmed")
    if not os.path.isdir(flac_root):
        return root  # VCTKDataset raises for the missing tree
    from .vctk import convert_flac_corpus

    done_marker = root.rstrip("/") + ".converted"
    if process_rank() == 0:  # under the process group the CLI's ranks join
        if logger:
            logger.info(f"Trimmed wav files not found; converting flac to wav "
                        f"({flac_root} -> {root})")
        convert_flac_corpus(flac_root, root, config.DATA.FLAC2WAV.TIMESTAMPS,
                            mic_id=config.DATA.MIC_ID)
        with open(done_marker, "w") as f:
            f.write("ok\n")
    else:
        while not os.path.exists(done_marker):
            time.sleep(5.0)
    return root


def get_loaders(config, logger=None, dataset=None, shard_index: int = 0,
                shard_count: int = 1):
    """Loader factory (reference data_loaders.py:25-79).

    Returns (train pipeline, valid pipeline) in training mode, or one test
    pipeline in eval mode: ``DataPipeline`` (threads), or ``WorkerPipeline``
    (worker processes) under DATA.PIPELINE grain. ``dataset`` may be given
    (e.g. SyntheticVCTK); otherwise it is the trimmed VCTK wav tree under
    DATA.DATA_PATH, converted from the raw FLAC corpus first if needed.

    ``shard_index`` / ``shard_count``: a rank of a data-parallel run (its
    rank, dp). Its training pipeline reads its DATA.BATCH_SIZE / dp rows of
    each global batch of DATA.BATCH_SIZE; where DATA.BATCH_SIZE does not
    divide over dp, every rank reads whole batches (the Trainer then
    replicates them, with a warning). The validation pipeline reads whole
    batches on every rank, which the Trainer shards."""
    from .vctk import VCTKDataset
    from .worker_pipeline import WorkerPipeline

    pipeline_cls = (WorkerPipeline if config.DATA.get("PIPELINE", "threads") == "grain"
                    else DataPipeline)
    training = not config.EVAL_MODE
    if dataset is None:
        dataset = VCTKDataset(
            ensure_wav_tree(config, logger),
            training=training,
            mic_id=config.DATA.MIC_ID,
            train_split=tuple(config.DATA.TRAIN_SPLIT),
            use_quantity=config.DATA.USE_QUANTITY,
            seed=config.SEED,
        )

    if training:
        sampler = DegradingSampler(dataset, config, training=True)
        tr_idx, va_idx = train_valid_split(len(dataset), config.DATA.VALID_SPLIT)
        common = dict(batch_size=config.DATA.BATCH_SIZE, seed=config.SEED,
                      num_workers=config.DATA.NUM_WORKERS)
        shards = {}
        if shard_count > 1 and config.DATA.BATCH_SIZE % shard_count == 0:
            shards = dict(shard_index=shard_index, shard_count=shard_count,
                          batch_size=config.DATA.BATCH_SIZE // shard_count)
        train = pipeline_cls(sampler, indices=tr_idx, shuffle=config.DATA.SHUFFLE,
                             **{**common, **shards})
        valid = pipeline_cls(sampler, indices=va_idx, shuffle=False, **common)
        if logger:
            logger.info(f"Data: {len(tr_idx)} train / {len(va_idx)} valid samples")
        return train, valid

    # Eval: batch 1, in order, the input rate from the TAG
    # (reference data_loaders.py:67-76, 455).
    input_sr = int(config.TAG.split("_")[0])
    sampler = DegradingSampler(dataset, config, training=False, input_sr=input_sr)
    return pipeline_cls(sampler, batch_size=1, shuffle=False, seed=config.SEED,
                        num_workers=config.DATA.NUM_WORKERS, drop_last=False)
