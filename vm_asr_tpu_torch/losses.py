"""Loss functions: waveform, multi-resolution STFT, HiFi-GAN adversarial
(port of vm_asr_tpu/losses.py; reference model/loss.py:5-260).

Scores and feature maps of bf16 discriminators are reduced in float32, as in
the JAX package (there by type promotion, which keeps float64 inputs float64;
``_acc`` does the same here).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from .dsp import stft


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in at least float32."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def mae_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (output - target).abs().mean()


def mse_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (output - target).square().mean()


def _stft_mag(x: torch.Tensor, fft_size: int, hop_size: int, win_length: int,
              emphasize_high_freq: bool = False) -> torch.Tensor:
    """|STFT| with a 1e-7 power floor, shaped (B, frames, freqs)."""
    spec = stft(x, fft_size, hop_size, win_length)  # Hann, centred, unnormalised
    mag = torch.sqrt(torch.clamp_min(spec.real.square() + spec.imag.square(), 1e-7))
    mag = mag.transpose(-1, -2)
    if emphasize_high_freq:
        # The frequency axis, as the flag intends (the JAX package's
        # documented deviation from the reference, losses.py:47-56).
        w = torch.linspace(1.0, 2.0, mag.shape[-1], device=mag.device, dtype=mag.dtype)
        mag = mag * w
    return mag


def spectral_convergence_loss(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    """‖Y − X‖_F / ‖Y‖_F."""
    return torch.linalg.norm((y_mag - x_mag).flatten()) / torch.linalg.norm(y_mag.flatten())


def log_stft_magnitude_loss(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    """L1 on log magnitudes."""
    return (torch.log(y_mag) - torch.log(x_mag)).abs().mean()


def stft_loss(x: torch.Tensor, y: torch.Tensor, fft_size: int = 1024,
              shift_size: int = 120, win_length: int = 600,
              emphasize_high_freq: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    x_mag = _stft_mag(x, fft_size, shift_size, win_length, emphasize_high_freq)
    y_mag = _stft_mag(y, fft_size, shift_size, win_length, emphasize_high_freq)
    return spectral_convergence_loss(x_mag, y_mag), log_stft_magnitude_loss(x_mag, y_mag)


def multi_resolution_stft_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    fft_sizes: Sequence[int] = (1024, 2048, 512),
    hop_sizes: Sequence[int] = (120, 240, 50),
    win_lengths: Sequence[int] = (600, 1200, 240),
    factor_sc: float = 0.5,
    factor_mag: float = 0.5,
    emphasize_high_freq: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ParallelWaveGAN-style multi-resolution STFT loss on (B, T) waveforms.
    Returns (sc_loss, mag_loss), already scaled by their factors."""
    sc_total, mag_total = 0.0, 0.0
    for fs, hs, wl in zip(fft_sizes, hop_sizes, win_lengths):
        sc, mag = stft_loss(x, y, fs, hs, wl, emphasize_high_freq)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    k = len(fft_sizes)
    return factor_sc * sc_total / k, factor_mag * mag_total / k


def discriminator_loss(real_scores: List[torch.Tensor], gen_scores: List[torch.Tensor],
                       gan_loss_type: str = "lsgan") -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(real_scores, gen_scores):
        dr, dg = _acc(dr), _acc(dg)
        if gan_loss_type == "lsgan":
            loss = loss + (dr - 1.0).square().mean() + dg.square().mean()
        else:  # wgan / wgan-gp
            loss = loss - dr.mean() + dg.mean()
    return loss


def generator_adversarial_loss(gen_scores: List[torch.Tensor],
                               gan_loss_type: str = "lsgan") -> torch.Tensor:
    loss = 0.0
    for dg in gen_scores:
        dg = _acc(dg)
        if gan_loss_type == "lsgan":
            loss = loss + (1.0 - dg).square().mean()
        else:
            loss = loss - dg.mean()
    return loss


def feature_matching_loss(fmap_real, fmap_gen) -> torch.Tensor:
    """Mean L1 over every layer of every sub-discriminator, normalised by the
    total layer count."""
    loss, count = 0.0, 0
    for dr, dg in zip(fmap_real, fmap_gen):
        for rl, gl in zip(dr, dg):
            loss = loss + (_acc(rl) - _acc(gl)).abs().mean()
            count += 1
    return loss / max(count, 1)


def gradient_penalty(disc_apply: Callable[[torch.Tensor], List[torch.Tensor]],
                     real: torch.Tensor, fake: torch.Tensor, alpha: torch.Tensor,
                     gp_weight: float = 10.0) -> torch.Tensor:
    """WGAN-GP penalty on interpolates ``alpha·real + (1 − alpha)·fake``
    (reference loss.py:237-260). ``alpha`` (B, 1, ..., 1) is drawn by the
    caller from a torch.Generator (the JAX package draws it from its rng
    here). The gradient is taken with create_graph=True, so the penalty is
    differentiable in the discriminator's parameters."""
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    score_sum = sum(s.sum() for s in disc_apply(interp))
    (grads,) = torch.autograd.grad(score_sum, interp, create_graph=True)
    norms = torch.sqrt(grads.reshape(grads.shape[0], -1).square().sum(1) + 1e-12)
    return gp_weight * (norms - 1.0).square().mean()
