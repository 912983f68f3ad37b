"""Image classification with the VMamba classifier (MODEL.TYPE "vssm").

A request is a batch of images as a client holds them, (B, H, W, 3) uint8
on the host; ``Classifier.classify`` copies it to the device, normalises it
there with ImageNet's mean and std (VMamba's evaluation transform), runs
the forward through ``make_forward_fn`` (on the card, a CUDA graph per
batch shape) and returns the fp32 logits on the host with the top-5 class
ids. Under a profiler a request records the spans (``core.profiling.span``)
request > load, classifier (``images``, and ``graph_replays`` from the
forward), save.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.device import resolve_device
from ..core.profiling import span
from ..models.factory import build_classifier
from .steps import make_forward_fn

# ImageNet's per-channel mean and std on the 0..255 scale (timm's
# IMAGENET_DEFAULT_MEAN/STD, which VMamba's data pipeline uses).
IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)
TOP_K = 5


class Classified(NamedTuple):
    logits: torch.Tensor  # (B, classes) fp32, on the host
    top5: torch.Tensor    # (B, min(5, classes)) int64 class ids, best first


class Classifier:
    """Serves ``model`` (default: ``build_classifier(config, device)``) on
    ``device`` (default the card; a CUDA device without CUDA raises). The
    model is moved there."""

    def __init__(self, config, model: Optional[torch.nn.Module] = None, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        model = build_classifier(config, self.device) if model is None else model
        self.model = model.to(self.device)
        self.forward = make_forward_fn(self.model)
        self.mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self.std = torch.tensor(IMAGENET_STD, device=self.device)

    def load_input(self, images) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the host → the normalised fp32 images on
        the device."""
        x = torch.as_tensor(images)
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected (B, H, W, 3) uint8 images, got {tuple(x.shape)} {x.dtype}")
        return (x.to(self.device).float() - self.mean) / self.std

    def classify(self, images) -> Classified:
        with span("request"):
            with span("load"):
                x = self.load_input(images)
            with span("classifier", images=int(x.shape[0])):
                logits = self.forward(x)
            with span("save"):
                logits = logits.float().cpu()  # waits for the device
                top5 = logits.topk(min(TOP_K, logits.shape[-1]), dim=-1).indices
        return Classified(logits, top5)
