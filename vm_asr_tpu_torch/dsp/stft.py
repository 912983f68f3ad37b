"""STFT and waveform <-> (log-magnitude, phase) images (port of
vm_asr_tpu/dsp/stft.py).

The JAX package re-implements torch.stft / torch.istft semantics; here they
are the native calls: periodic Hann window (centre-padded to ``n_fft`` when
shorter), ``center=True`` reflect padding, one-sided spectra laid out
``(..., freqs, frames)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window default), float32."""
    return torch.hann_window(win_length, periodic=True, dtype=torch.float32,
                             device=device)


def stft(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    normalized: bool = False,
) -> torch.Tensor:
    """Complex one-sided spectrum ``(..., n_fft // 2 + 1, frames)`` of a real
    signal ``(..., T)``: periodic Hann window of ``win_length`` (default
    ``n_fft``), centre-padded to ``n_fft`` when shorter, ``center=True``
    reflect padding, frames taken in x's float dtype.

    On the card each signal is its own transform: cuFFT rounds a batch of
    other size differently (2.7e-7 of the largest |S| between batch 2 and
    4), and the generator turns that into O(1), where the phase of a bin
    near ±π flips sign and where log2 takes an empty band's rounding, so a
    signal's spectrum must not depend on the batch it came in (data
    parallelism splits batches, serving pads them to bucket sizes). The
    CPU's FFT gives the same bits at any batch size."""
    win_length = win_length or n_fft
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1])
    kwargs = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                  window=hann_window(win_length, x.device).to(x.dtype), center=True,
                  pad_mode="reflect", normalized=normalized, onesided=True, return_complex=True)
    if rows.is_cuda and rows.shape[0] > 1:
        spec = torch.cat([torch.stft(r, **kwargs) for r in rows.split(1)])
    else:
        spec = torch.stft(rows, **kwargs)
    return spec.reshape(lead + spec.shape[-2:])


def amplitude_to_db(power: torch.Tensor, top_db: float = 80.0) -> torch.Tensor:
    """torchaudio AmplitudeToDB(stype='power', top_db=80) semantics."""
    db = 10.0 * torch.log10(torch.clamp_min(power, 1e-10))
    return torch.maximum(db, db.max() - top_db)


def db_to_amplitude(db: torch.Tensor) -> torch.Tensor:
    """torchaudio DB_to_amplitude(ref=1, power=1)."""
    return torch.pow(10.0, db * 0.1)


def wav2spectro(
    waveform: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    spectro_scale: str = "log2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """STFT → (magnitude, phase), each ``(..., n_fft // 2 + 1, frames)``.

    log2 scale: ``log2(|S| + 1e-8)``; dB scale: power dB with an 80 dB floor.
    """
    spec = stft(waveform.float(), n_fft, hop_length, win_length, normalized=True)
    phase = torch.angle(spec)
    if spectro_scale == "dB":
        mag = amplitude_to_db(spec.abs().square())
    else:
        mag = torch.log2(spec.abs() + 1e-8)
    return mag, phase


def spectro2wav(
    mag: torch.Tensor,
    phase: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    spectro_scale: str = "log2",
) -> torch.Tensor:
    """(magnitude, phase) → waveform of ``(frames - 1) * hop_length`` samples.

    ``n_fft`` is re-derived from the frequency axis (``2 * freqs - 2``), as
    the reference does, so images with the DC bin re-attached invert.
    """
    freqs = mag.shape[-2]
    n_fft = 2 * freqs - 2
    if spectro_scale == "dB":
        amp = torch.sqrt(db_to_amplitude(mag))
    else:
        amp = torch.exp2(mag)
    spec = torch.polar(amp.float(), phase.float())
    lead = spec.shape[:-2]
    wav = torch.istft(
        spec.reshape((-1,) + spec.shape[-2:]),
        n_fft=n_fft,
        hop_length=hop_length,
        win_length=win_length,
        window=hann_window(win_length, mag.device),
        center=True,
        normalized=True,
        onesided=True,
    )
    return wav.reshape(lead + wav.shape[-1:])
