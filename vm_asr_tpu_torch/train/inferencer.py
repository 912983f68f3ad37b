"""Inference engine for wav files and directories (port of
vm_asr_tpu/train/inferencer.py; reference trainer/inferencer.py:16-237).

Loads a wav, resamples it to the target rate, mono-mixes, pads it with white
noise to a segment multiple, runs the (segmented) forward and writes
``<stem>_enhanced.wav``.

Reference quirk kept: ``highcut`` is computed *after* resampling to the
target rate, so it is the full band (1 + n_fft // 2) whenever the tag's
target rate equals DATA.TARGET_SR, whatever the input's true bandwidth.
"""

from __future__ import annotations

import glob
import os
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.logging import create_logger
from ..dsp import fold_audio, load_wav, resample_audio, save_wav, unfold_audio
from .steps import bucketed_forward, make_forward_fn


class Inferencer:
    """Runs ``generator`` on ``device`` (default the card; a CUDA device
    without CUDA raises). The generator is moved there."""

    def __init__(self, config, generator: torch.nn.Module, logger=None,
                 output_dir: Optional[str] = None, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.generator = generator.to(self.device)
        self.logger = logger or create_logger(config.OUTPUT)
        parts = config.TAG.split("_")
        self.input_sr = int(parts[0])
        self.target_sr = int(parts[1])
        self.num_frames_per_seg = int(config.DATA.SEGMENT * self.target_sr)
        self.output_dir = output_dir or os.path.join(
            config.INFERENCE.RESULTS_DIR, config.MODEL.NAME
        )
        os.makedirs(self.output_dir, exist_ok=True)
        self.forward = make_forward_fn(self.generator)

    def load_input(self, file_path: str):
        """(x (1, 1, T) on the device, highcut (1,), pad samples)."""
        audio, sr = load_wav(file_path)
        if sr != self.target_sr:
            audio = resample_audio(audio, sr, self.target_sr)
            sr = self.target_sr

        seg = self.num_frames_per_seg
        t = audio.shape[-1]
        pad = (seg - t) if t < seg else (seg - t % seg) % seg
        if pad:
            noise = (
                np.random.default_rng(0).standard_normal(pad).astype(np.float32)
                * self.config.DATA.PAD_WHITENOISE
            )
            audio = np.concatenate([audio, noise])

        highcut = int(
            (1 + self.config.DATA.STFT.N_FFT // 2) * (sr / self.config.DATA.TARGET_SR)
        )
        x = torch.from_numpy(np.ascontiguousarray(audio[None, None, :], np.float32))
        hf = torch.tensor([highcut], dtype=torch.int64)
        return x.to(self.device), hf.to(self.device), pad

    def forward_chunked(self, x: torch.Tensor, hf: torch.Tensor) -> torch.Tensor:
        """One forward for a clip of at most one segment; longer clips are
        unfolded into segments, run in buckets and folded back."""
        seg_len = self.num_frames_per_seg
        overlap = self.config.INFERENCE.OVERLAP
        t = x.shape[-1]
        if t <= seg_len:
            return self.forward(x, hf)
        segments = unfold_audio(x, seg_len, overlap)
        s = segments.shape[2]
        out = bucketed_forward(
            self.forward, segments.reshape(s, 1, seg_len), hf.expand(s)
        ).reshape(1, 1, s, seg_len)
        return fold_audio(out, t, seg_len, overlap)

    def infer_file(self, file_path: str, output_dir: Optional[str] = None,
                   quiet: bool = False) -> Optional[torch.Tensor]:
        if not os.path.exists(file_path):
            self.logger.error(f"File not found: {file_path}")
            return None
        output_dir = output_dir or self.output_dir
        os.makedirs(output_dir, exist_ok=True)

        x, hf, _pad = self.load_input(file_path)
        t0 = time.time()
        wave_out = self.forward_chunked(x, hf)
        audio = wave_out[0, 0].cpu().numpy()  # waits for the device
        if not quiet:
            self.logger.info(f"Processing completed in {time.time() - t0:.2f}s")

        out_path = os.path.join(output_dir, f"{Path(file_path).stem}_enhanced.wav")
        save_wav(out_path, audio, self.target_sr)
        if not quiet:
            self.logger.info(f"Enhanced audio saved to {out_path}")
        return wave_out

    def infer_directory(self, dir_path: str, output_dir: Optional[str] = None,
                        file_types=(".wav",)) -> List[str]:
        if not os.path.exists(dir_path):
            self.logger.error(f"Directory not found: {dir_path}")
            return []
        output_dir = output_dir or os.path.join(self.output_dir, os.path.basename(dir_path))
        os.makedirs(output_dir, exist_ok=True)

        files = []
        for ext in file_types:
            files.extend(glob.glob(os.path.join(dir_path, f"*{ext}")))
        if not files:
            self.logger.warning(f"No audio files found in {dir_path}")
            return []
        self.logger.info(f"Found {len(files)} audio files to process")

        processed = []
        for fp in sorted(files):
            if self.infer_file(fp, output_dir, quiet=True) is not None:
                processed.append(os.path.join(output_dir, f"{Path(fp).stem}_enhanced.wav"))
        self.logger.info(f"Processed {len(processed)} files")
        return processed
