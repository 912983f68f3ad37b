"""Seeded speech-like signals, made on the device in a few vectorised calls.

A clip is a voiced source, a sum of harmonics of a pitch that glides
around its centre (a 0.7 Hz drift of ±15 %), with syllable-rate amplitude
(3.5 Hz), and a breath-noise floor at -40 dB, peak-normalised to 0.5. The
harmonics stop below 0.45 × the rate, so the signal fills its band and no
more. The sizes never come from the seed: only the content does.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

HARMONICS = 24


def lengths(mix: dict, count: int) -> List[float]:
    """``count`` clip lengths in seconds: the quantiles (i + ½)/count of the
    mix's length distribution, the same for every seed."""
    spec = mix["length"]
    q = (np.arange(count) + 0.5) / count
    if spec["dist"] == "lognormal":
        from scipy.stats import norm

        s = spec["median_s"] * np.exp(spec["sigma"] * norm.ppf(q))
    elif spec["dist"] == "uniform":
        s = spec["min_s"] + q * (spec["max_s"] - spec["min_s"])
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [float(v) for v in np.clip(s, spec.get("min_s", 0.0), spec.get("max_s", np.inf))]


def speech(samples: Sequence[int], sr: int, gen: torch.Generator, device) -> List[torch.Tensor]:
    """One float32 waveform of each length in ``samples``, at rate ``sr``."""
    n = len(samples)
    total = int(sum(samples))
    owner = torch.repeat_interleave(torch.arange(n, device=device),
                                    torch.as_tensor(list(samples), device=device))
    starts = torch.cumsum(torch.as_tensor([0] + list(samples[:-1]), device=device), 0)
    t = (torch.arange(total, device=device) - starts[owner]).float() / sr
    draw = torch.rand(n, 4, generator=gen, device=device)
    f0 = (90 + 160 * draw[:, 0])[owner] * (1 + 0.15 * torch.sin(
        2 * math.pi * 0.7 * t + 2 * math.pi * draw[:, 1][owner]))
    env = (0.5 + 0.5 * torch.sin(2 * math.pi * 3.5 * t + 2 * math.pi * draw[:, 2][owner])) ** 2
    # The phase of each clip's source, integrated within the clip.
    step = 2 * math.pi * f0.double() / sr
    phase = torch.cumsum(step, 0)
    phase = (phase - (phase - step)[starts][owner]).float()
    voiced = torch.zeros(total, device=device)
    for h in range(1, HARMONICS + 1):
        voiced += torch.where(h * f0 < 0.45 * sr, torch.sin(h * phase) / h, 0.0)
    noise = torch.randn(total, generator=gen, device=device)
    x = env * voiced + 0.01 * noise
    clips = list(x.split(list(samples)))
    return [c * (0.5 / c.abs().max().clamp_min(1e-6)) for c in clips]


def lowpass(x: torch.Tensor, cutoff_hz: torch.Tensor, sr: int) -> torch.Tensor:
    """(B, T) signals with every bin at or above each row's cutoff zeroed."""
    spec = torch.fft.rfft(x.double(), dim=-1)
    freqs = torch.fft.rfftfreq(x.shape[-1], 1.0 / sr).to(x.device)
    spec = torch.where(freqs[None] < cutoff_hz.to(x.device)[:, None].double(), spec, 0)
    return torch.fft.irfft(spec, n=x.shape[-1], dim=-1).float()
