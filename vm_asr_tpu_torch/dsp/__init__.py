from .audio import load_wav, resample_audio, save_wav
from .segment import fold_audio, num_segments, unfold_audio
from .stft import (
    amplitude_to_db,
    db_to_amplitude,
    hann_window,
    spectro2wav,
    stft,
    wav2spectro,
)

__all__ = [
    "amplitude_to_db",
    "db_to_amplitude",
    "fold_audio",
    "hann_window",
    "load_wav",
    "num_segments",
    "resample_audio",
    "save_wav",
    "spectro2wav",
    "stft",
    "unfold_audio",
    "wav2spectro",
]
