"""Scoring documents with the Jamba language model (MODEL.TYPE "jamba").

A request is one document of token ids on the host, a 1-D int64 array of
L ≥ 2 ids; ``Scorer.score`` returns each next token's log-probability,
log p(ids[t+1] | ids[≤t]) for t < L − 1, in fp32 on the host, and their
sum: what evaluation harnesses' log-likelihood and perplexity runs,
rerankers and reward scorers ask of a model.

The ids are copied to the device and right-padded with id 0 to the next
multiple of ``BUCKET_TOKENS``; the forward runs through
``make_forward_fn`` (on the card, one CUDA graph per bucket) and returns
the gathered log-probabilities, the head's log-softmax taken over blocks of
rows (``models/jamba.py``). Right padding is exact for a causal model: a
padded position reaches no earlier one, in the convolution, the scan or
the causal attention. The padded positions are dropped before the copy
back. Under a profiler a request records the spans (``core.profiling.span``)
request > load, lm (``tokens``, ``bucket_tokens``, and ``graph_replays``
from the forward), save.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.profiling import span
from ..models.factory import build_language_model
from .steps import make_forward_fn

# Documents are padded to a multiple of this many tokens: one forward shape,
# and one graph, per bucket.
BUCKET_TOKENS = 1024


class Scored(NamedTuple):
    logprobs: torch.Tensor  # (L − 1,) fp32 on the host: log p(ids[t+1] | ids[≤t])
    total: float            # their sum


class Scorer:
    """Serves ``model`` (default: ``build_language_model(config, device)``)
    on ``device`` (default the card; a CUDA device without CUDA raises).
    The model is moved there."""

    def __init__(self, config, model: Optional[torch.nn.Module] = None, device="cuda"):
        self.device = resolve_device(device)
        model = build_language_model(config, self.device) if model is None else model
        self.model = model.to(self.device)
        self.forward = make_forward_fn(self.model)
        self.vocab = self.model.embed_tokens.num_embeddings

    def load_input(self, ids) -> torch.Tensor:
        """(L,) int64 ids on the host → (1, bucket) on the device, padded on
        the right with id 0."""
        x = torch.as_tensor(ids)
        if x.dtype != torch.int64 or x.dim() != 1 or x.shape[0] < 2:
            raise ValueError(f"expected a 1-D int64 array of at least 2 token ids, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if int(x.min()) < 0 or int(x.max()) >= self.vocab:
            raise ValueError(f"token ids must lie in [0, {self.vocab})")
        n = x.shape[0]
        bucket = -(-n // BUCKET_TOKENS) * BUCKET_TOKENS
        return F.pad(x.to(self.device), (0, bucket - n))[None]

    def score(self, ids) -> Scored:
        with span("request"):
            with span("load"):
                x = self.load_input(ids)
                n = len(ids)
            with span("lm", tokens=n, bucket_tokens=int(x.shape[1])):
                logprobs = self.forward(x)
            with span("save"):
                logprobs = logprobs[0, :n - 1].cpu()  # waits for the device
        return Scored(logprobs, float(logprobs.double().sum()))
