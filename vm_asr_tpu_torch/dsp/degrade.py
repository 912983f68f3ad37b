"""Host-side audio degradation: low-pass filtering and polyphase resampling
(port of vm_asr_tpu/dsp/degrade.py; reference
data_loader/data_loaders.py:309-347, 523-535, 538-566).

These run on the host in the pipeline's threads or worker processes, so the
data's randomness stays there. As in the JAX package, a 1-D signal is
filtered (with at most 16 second-order sections) and resampled by the host
C++ library (``data/native.py``), anything else by scipy; the C++ path
agrees with scipy within 1e-5 (tests/test_torch_native.py).

Reference quirk, kept: ``_get_io_pair`` (data_loaders.py:457-478) computes the
low-passed signal and then resamples the *original* target, so the explicit
filter has no effect and ``resample_poly``'s own anti-aliasing filter is what
band-limits the input. ``apply_lpf=True`` applies the filter before
downsampling.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.signal import bessel, butter, cheby1, ellip, sosfiltfilt

from .audio import resample_audio


def lowpass(
    audio: np.ndarray,
    highcut: float,
    filter_: Tuple[str, int] = ("cheby1", 8),
    sr: int = 48000,
) -> np.ndarray:
    """Zero-phase IIR low-pass (reference data_loaders.py:538-566)."""
    wn = highcut / (sr / 2.0)
    kind, order = filter_[0], int(filter_[1])
    if kind == "butter":
        sos = butter(order, wn, btype="lowpass", output="sos")
    elif kind == "cheby1":
        sos = cheby1(order, 0.05, wn, btype="lowpass", output="sos")
    elif kind == "bessel":
        sos = bessel(order, wn, norm="mag", btype="lowpass", output="sos")
    elif kind == "ellip":
        sos = ellip(order, 0.05, 20, wn, btype="lowpass", output="sos")
    else:
        raise ValueError(f"Unknown filter kind: {kind}")
    if audio.ndim == 1 and sos.shape[0] <= 16:
        from ..data import native  # here: data/ imports this module

        try:
            return native.sosfiltfilt(sos, audio.astype(np.float32, copy=False))
        except ValueError:
            pass  # too short for the padding: scipy raises its own error below
    return sosfiltfilt(sos, audio, axis=-1).astype(np.float32, copy=False)


def align_waveform(resampled: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Pad or trim ``resampled`` to the length of ``target``
    (reference data_loaders.py:523-535)."""
    t = target.shape[-1]
    r = resampled.shape[-1]
    if r < t:
        pad = [(0, 0)] * (resampled.ndim - 1) + [(0, t - r)]
        return np.pad(resampled, pad)
    return resampled[..., :t]


def degrade(
    target: np.ndarray,
    sr_target: int,
    sr_input: int,
    filter_: Tuple[str, int],
    n_fft: int,
    apply_lpf: bool = False,
) -> Tuple[np.ndarray, int]:
    """The low-resolution input made from the high-resolution target.

    Returns ``(input_waveform, highcut_bin)`` with
    ``highcut_bin = int((1 + n_fft // 2) * sr_input / sr_target)``
    (reference data_loaders.py:482-486).
    """
    if sr_input != sr_target:
        src = target
        if apply_lpf:
            src = lowpass(src, int(sr_input * 0.5), filter_, sr_target)
        down = resample_audio(src, sr_target, sr_input)
        up = resample_audio(down, sr_input, sr_target)
        x = align_waveform(up, target)
    else:
        x = target
    highcut = int((1 + n_fft // 2) * (sr_input / sr_target))
    return x, highcut
