"""The work of one served segment and of one training step, counted on the
reference on the meta device (shapes only, no memory, no arithmetic):
FLOPs of the products (``flops.matmul_flops``) and the scans' calls
(B, L, K·D, N), which ``scan_bytes`` turns into bytes.

The STFT, the losses' spectra and the iSTFT count no FLOPs, so the counts
start from the generator's images: one segment of T samples is a
(n_fft / 2) × (T / hop + 1) magnitude image and a phase image.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..reference.generator import Generator
from ..reference.mpd import MPD
from ..reference.precision import Products
from .flops import matmul_flops


def _images(cfg: dict, batch: int, seg_samples: int):
    stft = cfg["DATA"]["STFT"]
    hop = stft["HOP_LENGTH"]
    frames = -(-seg_samples // hop) + 1
    shape = (batch, stft["N_FFT"] // 2, frames)
    return torch.empty(shape, device="meta"), torch.empty(shape, device="meta")


def segment_work(cfg: dict, seg_samples: int) -> Dict[str, object]:
    """FLOPs and scan calls of one segment's forward."""
    with torch.device("meta"):
        gen = Generator(cfg, Products("fp32")).eval()
    gen.env.scan_record = []
    mag, phase = _images(cfg, 1, seg_samples)
    with torch.no_grad():
        flops = matmul_flops(gen.network, mag, phase)
    return {"flops": flops, "scan_calls": gen.env.scan_record}


def step_work(cfg: dict, batch: int, seg_samples: int) -> Dict[str, object]:
    """FLOPs and the generator's scan calls of one GAN step: the
    generator's forward and its parameters' gradient; the discriminator on
    real and fake as one batch, differentiated in the fake; and the
    discriminator on each alone, differentiated in its parameters."""
    with torch.device("meta"):
        gen = Generator(cfg, Products("fp32")).eval()  # DropPath adds no product
        mpd = MPD(cfg, Products("fp32"))
    gen.env.scan_record = []
    mag, phase = _images(cfg, batch, seg_samples)
    y = torch.empty(batch, 1, seg_samples, device="meta")
    fake = torch.empty(batch, 1, seg_samples, device="meta", requires_grad=True)

    def total(outs):
        return sum(t.sum() for t in outs)

    def generator_pass():
        m, p = gen.network(mag, phase)
        torch.autograd.grad(m.sum() + p.sum(), list(gen.parameters()), allow_unused=True)

    def adversarial_pass():
        s_r, s_g, f_r, f_g = mpd(y, fake, update_stats=False)
        torch.autograd.grad(total(s_g) + total(t for f in f_g for t in f), [fake])

    def discriminator_pass():
        s_r, s_g, _, _ = mpd(y, fake.detach(), update_stats=True)
        torch.autograd.grad(total(s_r) + total(s_g), list(mpd.parameters()))

    flops = sum(matmul_flops(f) for f in (generator_pass, adversarial_pass,
                                          discriminator_pass))
    return {"flops": flops, "scan_calls": gen.env.scan_record}
