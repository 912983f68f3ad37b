"""VCTK 0.92 dataset on the host, numpy only (port of vm_asr_tpu/data/vctk.py;
reference data_loader/data_loaders.py:82-520, CustomVCTK_092).

- the speaker split into train and test (TRAIN_SPLIT [100, 8], reference
  config.py:31 and data_loaders.py:248-307);
- the sample-id JSON cache and USE_QUANTITY subsampling
  (data_loaders.py:269-307);
- the FLAC-to-wav conversion with silence trimming from the
  vctk-silence-labels timestamps (data_loaders.py:151-246):
  ``convert_flac_corpus`` walks the raw VCTK 0.92 FLAC tree, decodes each
  file with the host C++ FLAC decoder (``data/native.py``), trims it and
  writes the 16-bit wav tree the dataset reads.

``SyntheticVCTK`` makes deterministic harmonic "speech" with the same
interface, for tests and smoke runs; it gives the JAX package's samples bit
for bit.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..dsp.audio import load_wav, save_wav

__all__ = ["EXCLUDED_SPEAKERS", "Sample", "SyntheticVCTK", "VCTKDataset", "convert_flac_corpus",
           "load_wav", "parse_silence_labels", "save_wav", "trim_silence"]


def parse_silence_labels(path: str) -> Dict[str, Tuple[float, float]]:
    """Parse vctk-silences.0.92.txt lines: `<utt_id> <start> <end>` seconds."""
    table: Dict[str, Tuple[float, float]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                table[parts[0]] = (float(parts[1]), float(parts[2]))
    return table


def trim_silence(
    audio: np.ndarray, sr: int, bounds: Optional[Tuple[float, float]]
) -> np.ndarray:
    """Keep [start, end] seconds per the silence-label timestamps."""
    if bounds is None:
        return audio
    start = max(0, int(bounds[0] * sr))
    end = min(audio.shape[-1], int(bounds[1] * sr))
    return audio[..., start:end]


EXCLUDED_SPEAKERS = ("p280", "p315")  # reference data_loaders.py:193-195


def convert_flac_corpus(
    flac_root: str,
    dst_root: str,
    timestamps_path: Optional[str] = None,
    mic_id: str = "mic1",
    overwrite: bool = False,
) -> int:
    """Convert a raw VCTK 0.92 FLAC tree to the trimmed wav layout
    (reference ``_flac2wav``, data_loaders.py:151-246).

    Walks ``{flac_root}/{speaker}/{speaker}_{utt}_{mic}.flac``, skips
    EXCLUDED_SPEAKERS, trims each utterance to its silence-label window and
    writes ``{dst_root}/{speaker}/{speaker}_{utt}.wav`` (16-bit PCM). An
    existing file is kept unless ``overwrite``. Each file is written under a
    per-process temporary name and renamed into place, so a concurrent
    converter sees either no file or the whole one. Returns the number of
    files written."""
    from .native import decode_flac

    labels = parse_silence_labels(timestamps_path) if timestamps_path else {}
    suffix = f"_{mic_id}.flac"
    written = 0
    for speaker in sorted(os.listdir(flac_root)):
        sdir = os.path.join(flac_root, speaker)
        if not os.path.isdir(sdir) or speaker in EXCLUDED_SPEAKERS:
            continue
        dst_dir = os.path.join(dst_root, speaker)
        for fname in sorted(f for f in os.listdir(sdir) if f.endswith(suffix)):
            utt = fname[: -len(suffix)]  # e.g. p225_001
            dst = os.path.join(dst_dir, f"{utt}.wav")
            if os.path.exists(dst) and not overwrite:
                continue
            audio, sr = decode_flac(os.path.join(sdir, fname))
            mono = trim_silence(audio[0], sr, labels.get(utt))
            os.makedirs(dst_dir, exist_ok=True)
            tmp = f"{dst}.tmp{os.getpid()}"
            save_wav(tmp, mono, sr)
            os.replace(tmp, dst)
            written += 1
    return written


@dataclass
class Sample:
    speaker_id: str
    utterance_id: str
    path: str


class VCTKDataset:
    """Speaker-split VCTK over a directory of wav files.

    Layout, the reference's converted corpus (data_loaders.py:119-149,
    197-218: ``_flac2wav`` writes ``{speaker}_{utt}.wav`` without the mic
    suffix, since the mic is chosen at conversion):
        <root>/<speaker>/<speaker>_<utt>.wav
    Files that carry a ``_mic{N}`` tag are accepted too and filtered to
    ``mic_id``.
    """

    def __init__(
        self,
        root: str,
        training: bool = True,
        mic_id: str = "mic1",
        train_split: Sequence[int] = (100, 8),
        use_quantity: float = 1.0,
        cache_path: Optional[str] = None,
        seed: int = 123,
    ):
        self.root = root
        self.training = training
        self.mic_id = mic_id
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"VCTK corpus not found at {root}. Place the silence-trimmed wav "
                "corpus there (layout: reference data_loaders.py:119-246), or use "
                "SyntheticVCTK for smoke runs."
            )
        self.samples = self._build_sample_ids(train_split, use_quantity, cache_path, seed)

    def _build_sample_ids(self, train_split, use_quantity, cache_path, seed):
        speakers = sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
        )
        n_train, n_test = train_split
        chosen = speakers[:n_train] if self.training else speakers[n_train:n_train + n_test]

        cache_key = f"{'train' if self.training else 'test'}_{self.mic_id}"
        if cache_path and os.path.exists(cache_path):
            with open(cache_path) as f:
                cached = json.load(f).get(cache_key)
            if cached:
                samples = [Sample(s, u, p) for s, u, p in cached]
                return self._subsample(samples, use_quantity, seed)

        samples: List[Sample] = []
        for spk in chosen:
            spk_dir = os.path.join(self.root, spk)
            for fname in sorted(os.listdir(spk_dir)):
                if not fname.endswith(".wav"):
                    continue
                parts = fname.rsplit(".", 1)[0].split("_")
                # The converted corpus has no mic tag; filter only where a
                # file carries one.
                if self.mic_id and parts[-1].startswith("mic"):
                    if parts[-1] != self.mic_id:
                        continue
                    parts = parts[:-1]
                samples.append(Sample(spk, "_".join(parts[1:]), os.path.join(spk_dir, fname)))

        if cache_path:
            existing = {}
            if os.path.exists(cache_path):
                with open(cache_path) as f:
                    existing = json.load(f)
            existing[cache_key] = [(s.speaker_id, s.utterance_id, s.path) for s in samples]
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            with open(cache_path, "w") as f:
                json.dump(existing, f)

        return self._subsample(samples, use_quantity, seed)

    @staticmethod
    def _subsample(samples, use_quantity, seed):
        if use_quantity < 1.0:
            # A random subset of the corpus (reference data_loaders.py:287-307).
            rng = np.random.default_rng(seed)
            idx = rng.permutation(len(samples))[: int(len(samples) * use_quantity)]
            samples = [samples[i] for i in sorted(idx)]
        return samples

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, i: int) -> Tuple[np.ndarray, int, str]:
        s = self.samples[i]
        audio, sr = load_wav(s.path)
        return audio, sr, f"{s.speaker_id}_{s.utterance_id}.wav"


class SyntheticVCTK:
    """A deterministic synthetic corpus with the VCTKDataset interface.

    Harmonic signals with a 100–300 Hz fundamental, partials up to Nyquist
    with a 1/k tilt and a fixed pseudo-formant envelope (so the high band is
    predictable from the low band, as in speech), random phases and an
    amplitude envelope. Item i is drawn from ``default_rng(seed + i)``
    (``seed + 10 000`` for the test split).
    """

    def __init__(self, n_items: int = 16, sr: int = 48000, duration: float = 2.8,
                 seed: int = 0, training: bool = True):
        self.n_items = n_items
        self.sr = sr
        self.duration = duration
        self.seed = seed + (0 if training else 10_000)
        self._cache: Dict[int, Tuple[np.ndarray, int, str]] = {}

    def __len__(self) -> int:
        return self.n_items

    def load(self, i: int) -> Tuple[np.ndarray, int, str]:
        # Deterministic per index, so memoised: the synthesis costs tens of
        # ms, a real corpus's disk read about one.
        if i in self._cache:
            return self._cache[i]
        out = self._synthesise(i)
        if len(self._cache) < 4096:
            self._cache[i] = out
        return out

    def _synthesise(self, i: int) -> Tuple[np.ndarray, int, str]:
        rng = np.random.default_rng(self.seed + i)
        t = np.arange(int(self.sr * self.duration)) / self.sr
        f0 = rng.uniform(100.0, 300.0)
        audio = np.zeros_like(t, dtype=np.float32)
        for k in range(1, 256):
            fk = f0 * k
            if fk >= self.sr / 2:
                break
            formant = 0.5 * (1.0 + np.sin(0.7 * k + f0 / 30.0))
            amp = (0.4 + 0.6 * formant) / k
            audio += (amp * np.sin(2 * np.pi * fk * t + rng.uniform(0, 2 * np.pi))
                      ).astype(np.float32)
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1.0, 4.0) * t))
        audio = (audio * env).astype(np.float32)
        audio /= max(np.abs(audio).max(), 1e-6)
        return 0.5 * audio, self.sr, f"synth_{i:04d}.wav"
