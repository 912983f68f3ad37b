"""Inference forward and segment bucketing (port of the forward part of
vm_asr_tpu/train/steps.py)."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def make_forward_fn(generator: torch.nn.Module) -> Callable:
    """forward(x, hf) → the generator's output, in eval and inference mode."""
    generator.eval()

    def forward(x: torch.Tensor, hf: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return generator(x, hf)

    return forward


# Segment-batch sizes for long clips: at most 8 segments per forward, and
# the tail chunk padded up to the next size, as the JAX package does (there
# to bound XLA's compiles; here it bounds the batch shapes a run sees).
SEG_BUCKETS = (1, 2, 4, 8)


def segment_bucket_counts(num_segments: int) -> Dict[int, int]:
    """How many chunks of each bucket size ``bucketed_forward`` runs for a
    ``num_segments``-segment clip."""
    counts, i = {}, 0
    while i < num_segments:
        rem = min(num_segments - i, SEG_BUCKETS[-1])
        b = next(x for x in SEG_BUCKETS if x >= rem)
        counts[b] = counts.get(b, 0) + 1
        i += rem
    return counts


def bucketed_forward(forward: Callable, seg_batch: torch.Tensor,
                     hf_batch: torch.Tensor) -> torch.Tensor:
    """Run S segments in chunks of at most 8, each padded to a bucket size.

    seg_batch: (S, 1, seg_len); hf_batch: (S,). Tail chunks are zero-padded
    (hf edge-padded) and the padded outputs dropped.
    """
    s = seg_batch.shape[0]
    outs = []
    i = 0
    while i < s:
        rem = min(s - i, SEG_BUCKETS[-1])
        b = next(x for x in SEG_BUCKETS if x >= rem)
        chunk = seg_batch[i:i + rem]
        hfc = hf_batch[i:i + rem]
        if rem < b:
            chunk = F.pad(chunk, (0, 0, 0, 0, 0, b - rem))
            hfc = torch.cat([hfc, hfc[-1:].expand(b - rem)])
        outs.append(forward(chunk, hfc)[:rem])
        i += rem
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
