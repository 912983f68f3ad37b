"""Evaluation metrics: SNR, LSD, LSD-HF, LSD-LF (port of vm_asr_tpu/metrics.py;
reference model/metric.py).

All take (B, T) waveforms. The HF/LF variants take a per-sample highcut bin
``hf`` (B,) and use masked means over the frequency axis, as the JAX package
does, in place of the reference's loop over the batch.
"""

from __future__ import annotations

import torch

from .dsp import stft


def _log_power_spec(x: torch.Tensor, n_fft: int = 2048, hop: int = 512) -> torch.Tensor:
    """log10(|STFT|²) with a 1e-8 floor, (B, freqs, frames)."""
    spec = stft(x, n_fft, hop)  # Hann, centred, unnormalised
    mag = torch.sqrt(spec.real.square() + spec.imag.square())
    return torch.log10(torch.clamp_min(mag.square(), 1e-8))


def snr(output: torch.Tensor, target: torch.Tensor, **_) -> torch.Tensor:
    """Mean per-sample SNR in dB."""
    num = torch.linalg.norm(target, dim=-1)
    den = torch.clamp_min(torch.linalg.norm(output - target, dim=-1), 1e-8)
    return (20.0 * torch.log10(num / den)).mean()


def lsd(output: torch.Tensor, target: torch.Tensor, **_) -> torch.Tensor:
    """Log-spectral distance: mean over frames of sqrt(mean over freqs of the
    squared log-power difference)."""
    sp, st = _log_power_spec(output), _log_power_spec(target)
    return torch.sqrt((sp - st).square().mean(-2)).mean()


def _lsd_band(output, target, hf, high: bool) -> torch.Tensor:
    sp, st = _log_power_spec(output), _log_power_spec(target)
    idx = torch.arange(sp.shape[-2], device=sp.device)[None, :, None]
    cut = hf.to(sp.device)[:, None, None]
    mask = (idx >= cut if high else idx < cut).to(sp.dtype)
    cnt = torch.clamp_min(mask.sum(-2), 1.0)
    mse_f = ((sp - st).square() * mask).sum(-2) / cnt  # (B, frames)
    return torch.sqrt(mse_f).mean()


def lsd_hf(output: torch.Tensor, target: torch.Tensor, hf: torch.Tensor) -> torch.Tensor:
    """LSD restricted to bins ≥ hf."""
    return _lsd_band(output, target, hf, high=True)


def lsd_lf(output: torch.Tensor, target: torch.Tensor, hf: torch.Tensor) -> torch.Tensor:
    """LSD restricted to bins < hf."""
    return _lsd_band(output, target, hf, high=False)


METRICS = {"snr": snr, "lsd": lsd, "lsd_hf": lsd_hf, "lsd_lf": lsd_lf}


def get_metrics(names):
    return {n: METRICS[n] for n in names}
