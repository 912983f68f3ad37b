"""Overlap-add segmentation for long-audio inference
(port of vm_asr_tpu/dsp/segment.py; reference utils/post_processing.py:4-33)."""

from __future__ import annotations

import torch


def num_segments(t: int, segment_length: int, overlap: int) -> int:
    """Number of windows :func:`unfold_audio` gives a ``T``-sample clip."""
    step = segment_length - overlap
    return 1 + max(0, (t - segment_length)) // step


def _window_index(n: int, segment_length: int, overlap: int, device) -> torch.Tensor:
    step = segment_length - overlap
    starts = torch.arange(n, device=device)[:, None] * step
    return starts + torch.arange(segment_length, device=device)[None, :]


def unfold_audio(audio: torch.Tensor, segment_length: int, overlap: int) -> torch.Tensor:
    """``(..., T)`` → ``(..., num_segments, segment_length)`` with stride
    ``segment_length - overlap`` (torch.Tensor.unfold semantics: trailing
    samples that fill no window are dropped). Needs T ≥ segment_length."""
    n = num_segments(audio.shape[-1], segment_length, overlap)
    return audio[..., _window_index(n, segment_length, overlap, audio.device)]


def fold_audio(segments: torch.Tensor, total_length: int, segment_length: int,
               overlap: int) -> torch.Tensor:
    """Inverse of :func:`unfold_audio`, averaging where windows overlap."""
    n = segments.shape[-2]
    idx = _window_index(n, segment_length, overlap, segments.device).reshape(-1)
    lead = segments.shape[:-2]
    acc = torch.zeros(lead + (total_length,), dtype=segments.dtype,
                      device=segments.device)
    acc.index_add_(-1, idx, segments.reshape(lead + (-1,)))
    count = torch.zeros(total_length, dtype=segments.dtype, device=segments.device)
    count.index_add_(0, idx, torch.ones_like(idx, dtype=segments.dtype))
    count = torch.where(count == 0, torch.ones_like(count), count)
    return acc / count
