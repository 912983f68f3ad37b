"""The published inference path, plainly (VM-ASR trainer/inferencer.py): read
a wav, mix it to mono, resample it to the target rate, pad it with white
noise to whole segments, run the generator on each overlapping segment and
average the overlaps back into one waveform."""

from __future__ import annotations

import numpy as np
import torch
from scipy.io import wavfile

from .dsp import fold, pad_to_segments, resample, unfold

ROWS = 4  # segments a forward: bounds the reference's memory, not its result


def read_wav(path: str):
    sr, data = wavfile.read(path)
    scale = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0}.get(data.dtype)
    data = data.astype(np.float32) / scale if scale else data.astype(np.float32)
    return (data.mean(axis=1) if data.ndim == 2 else data), sr


@torch.no_grad()
def enhance(generator, cfg: dict, path: str, device) -> torch.Tensor:
    """The enhanced waveform of the wav at ``path`` at DATA.TARGET_SR."""
    target_sr = int(cfg["TAG"].split("_")[1])
    seg = int(cfg["DATA"]["SEGMENT"] * target_sr)
    overlap = cfg["INFERENCE"]["OVERLAP"]
    audio, sr = read_wav(path)
    if sr != target_sr:
        audio = resample(audio, sr, target_sr)
    audio = pad_to_segments(audio, seg, cfg["DATA"]["PAD_WHITENOISE"])
    x = torch.from_numpy(audio).to(device)
    if x.shape[0] <= seg:
        return generator(x[None, None])[0, 0]
    segments = unfold(x, seg, overlap)
    out = torch.cat([generator(s[:, None])[:, 0] for s in segments.split(ROWS)])
    return fold(out, x.shape[0], overlap)
