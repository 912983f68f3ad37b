"""Host-side wav IO and resampling.

Ports of ``load_wav`` / ``save_wav`` (vm_asr_tpu/data/vctk.py:31-51) and
``resample_audio`` (vm_asr_tpu/dsp/degrade.py:63-72): a 1-D waveform goes
through the host C++ resampler (``data/native.py``), anything else through
scipy. The C++ resampler is not bitwise scipy's: it agrees with it within
1e-5 (tests/test_torch_native.py measures the difference).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a wav file → (float32 mono waveform in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data, sr


def save_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """Write 16-bit PCM, clipped to [-1, 1]."""
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (audio * 32767.0).astype(np.int16))


def resample_audio(waveform: np.ndarray, sr_org: int, sr_new: int) -> np.ndarray:
    """Polyphase resampling (reference data_loaders.py:338-345): C++ for a
    1-D waveform, scipy otherwise, as the JAX package chooses."""
    if waveform.ndim == 1:
        from ..data import native  # here: data/ imports this module

        return native.resample_poly(waveform.astype(np.float32, copy=False), sr_new, sr_org)
    return resample_poly(waveform, sr_new, sr_org, axis=-1).astype(
        np.float32, copy=False
    )
