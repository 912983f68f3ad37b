"""The work of the classifier's requests, counted on the reference on the
meta device (shapes only): FLOPs of the products of one image
(``flops.matmul_flops``) and the scans' calls (B, L, K·D, N) of one batch,
which ``scan_bytes`` turns into bytes. Normalising the images counts no
FLOPs, so the count starts from the normalised image, as ``work.py``'s
starts from the generator's spectrogram."""

from __future__ import annotations

from typing import Dict

import torch

from ..reference.precision import Products
from ..reference.vssm import VSSM
from .flops import matmul_flops


def image_work(cfg: dict, batch: int) -> Dict[str, object]:
    """FLOPs of one DATA.IMG_SIZE² image's forward, and the scan calls of a
    forward over ``batch`` of them."""
    with torch.device("meta"):
        model = VSSM(cfg, Products("fp32")).eval()
    size = cfg["DATA"]["IMG_SIZE"]
    with torch.no_grad():
        flops = matmul_flops(model.network, torch.empty(1, size, size, 3, device="meta"))
        model.env.scan_record = []
        model.network(torch.empty(batch, size, size, 3, device="meta"))
    return {"flops": flops, "scan_calls": model.env.scan_record}
