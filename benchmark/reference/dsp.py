"""Signal processing of the reference: STFT and its inverse, the
(log2-magnitude, phase) images, polyphase resampling, and the request
layer's padding and overlap-add.

On the card each signal is transformed on its own: cuFFT rounds a batch of
another size differently, and the generator turns a last-bit change in an
empty band's log2 or in a phase near ±π into a large one, so a signal's
spectrum must not depend on the batch it sits in. The program does the
same, so both sides start from the same spectra.
"""

from __future__ import annotations

from math import gcd
from typing import Tuple

import numpy as np
import torch
from scipy.signal import resample_poly


def hann(win_length: int, device) -> torch.Tensor:
    return torch.hann_window(win_length, periodic=True, dtype=torch.float32, device=device)


def stft(x: torch.Tensor, n_fft: int, hop: int, win: int, normalized: bool = False
         ) -> torch.Tensor:
    """One-sided complex spectrum (..., n_fft // 2 + 1, frames) of a real
    (..., T) signal: periodic Hann window, centred, reflect padding."""
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1]).float()
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win, window=hann(win, x.device),
              center=True, pad_mode="reflect", normalized=normalized, onesided=True,
              return_complex=True)
    spec = torch.cat([torch.stft(r, **kw) for r in rows.split(1)]) if rows.is_cuda \
        else torch.stft(rows, **kw)
    return spec.reshape(lead + spec.shape[-2:])


def wav2spectro(x: torch.Tensor, n_fft: int, hop: int, win: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log2(|S| + 1e-8), angle(S)) of the normalised STFT."""
    spec = stft(x, n_fft, hop, win, normalized=True)
    return torch.log2(spec.abs() + 1e-8), torch.angle(spec)


def spectro2wav(mag: torch.Tensor, phase: torch.Tensor, hop: int, win: int) -> torch.Tensor:
    """The normalised inverse STFT of 2**mag · e^(i·phase); n_fft from the
    frequency axis."""
    n_fft = 2 * mag.shape[-2] - 2
    spec = torch.polar(torch.exp2(mag.float()), phase.float())
    lead = spec.shape[:-2]
    wav = torch.istft(spec.reshape((-1,) + spec.shape[-2:]), n_fft=n_fft, hop_length=hop,
                      win_length=win, window=hann(win, mag.device), center=True,
                      normalized=True, onesided=True)
    return wav.reshape(lead + wav.shape[-1:])


def resample(x: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    """scipy's polyphase resampler in float64, returned as float32."""
    g = gcd(sr_from, sr_to)
    return resample_poly(x.astype(np.float64), sr_to // g, sr_from // g).astype(np.float32)


def pad_to_segments(audio: np.ndarray, seg: int, noise_scale: float) -> np.ndarray:
    """Pad to one segment, or to a whole number of segments, with white
    noise of ``noise_scale`` drawn from ``default_rng(0)`` (the published
    inference path's padding)."""
    t = audio.shape[-1]
    pad = (seg - t) if t < seg else (seg - t % seg) % seg
    if not pad:
        return audio
    noise = np.random.default_rng(0).standard_normal(pad).astype(np.float32) * noise_scale
    return np.concatenate([audio, noise])


def unfold(x: torch.Tensor, seg: int, overlap: int) -> torch.Tensor:
    """(T,) → (S, seg): windows of ``seg`` with stride seg − overlap; the
    samples that fill no window are dropped."""
    return x.unfold(0, seg, seg - overlap)


def fold(segments: torch.Tensor, total: int, overlap: int) -> torch.Tensor:
    """(S, seg) → (total,): the overlap-add of ``unfold``'s windows,
    averaged where they overlap."""
    s, seg = segments.shape
    step = seg - overlap
    acc = torch.zeros(total, dtype=segments.dtype, device=segments.device)
    count = torch.zeros(total, dtype=segments.dtype, device=segments.device)
    for i in range(s):
        acc[i * step:i * step + seg] += segments[i]
        count[i * step:i * step + seg] += 1
    return acc / torch.clamp_min(count, 1)
