"""The published training losses (VM-ASR model/loss.py): the
multi-resolution STFT loss, LSGAN's adversarial losses and feature
matching."""

from __future__ import annotations

import torch

from .dsp import stft


def _mag(x, fft, hop, win):
    spec = stft(x, fft, hop, win)
    return torch.sqrt(torch.clamp_min(spec.real.square() + spec.imag.square(), 1e-7)
                      ).transpose(-1, -2)


def multi_resolution_stft(x, y, sc_factor=0.5, mag_factor=0.5,
                          resolutions=((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))):
    """(B, T) waveforms → sc_factor · mean spectral convergence +
    mag_factor · mean log-magnitude L1, over the resolutions."""
    sc, mag = 0.0, 0.0
    for fft, hop, win in resolutions:
        xm, ym = _mag(x, fft, hop, win), _mag(y, fft, hop, win)
        sc = sc + torch.linalg.norm((ym - xm).flatten()) / torch.linalg.norm(ym.flatten())
        mag = mag + (torch.log(ym) - torch.log(xm)).abs().mean()
    k = len(resolutions)
    return sc_factor * sc / k + mag_factor * mag / k


def disc_loss(real, fake):
    return sum((r.float() - 1).square().mean() + f.float().square().mean()
               for r, f in zip(real, fake))


def gen_adv_loss(fake):
    return sum((1 - f.float()).square().mean() for f in fake)


def feature_loss(fmap_real, fmap_fake):
    terms = [(r.float() - f.float()).abs().mean()
             for dr, df in zip(fmap_real, fmap_fake) for r, f in zip(dr, df)]
    return sum(terms) / max(len(terms), 1)
