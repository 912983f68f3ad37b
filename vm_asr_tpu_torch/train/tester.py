"""Evaluation engine: chunked batch-1 inference, RTF, wav export and the
results CSV (port of vm_asr_tpu/train/tester.py; reference
trainer/tester.py:16-240 and base/base_tester.py).

- A clip of at most one segment runs in one forward; a longer one is cut
  into SEGMENT-long windows that overlap by TEST.OVERLAP samples, run in
  segment buckets (``bucketed_forward``) and averaged back together.
- RTF is wall seconds over audio seconds, the clock stopped after
  ``torch.cuda.synchronize()`` on the card. With TEST.COMPUTE_RTF the CSV
  also gets ``rtf_compute``: the clip's forwards priced at the device time
  per forward of each bucket shape, measured once at warm-up by CUDA events
  (``core.profiling.median_window_dt``).
- The metrics are taken on the padded clip, as the JAX package takes them;
  ``lsd_input`` (the degraded input's LSD, the floor to beat) is logged,
  not written to the CSV.
- ``_up`` / ``_orig`` / ``_down`` wavs go to the output directory, and a row
  is appended to ``results_{16,48}kHz.csv`` in the current directory with
  the reference's columns and then the compute-RTF ones.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional

import torch

from ..core.device import resolve_device
from ..core.logging import create_logger
from ..core.tracker import MetricTracker
from ..data.pipeline import batch_to_device
from ..dsp import fold_audio, num_segments, save_wav, unfold_audio
from ..metrics import get_metrics
from .steps import bucketed_forward, make_forward_fn, segment_bucket_counts

CSV_COLUMNS = ["sample_rate", "snr", "lsd", "lsd_hf", "lsd_lf", "rtf", "rtf_reciprocal"]
# After the reference's columns, so that its prefix of the CSV is unchanged.
COMPUTE_COLUMNS = ["rtf_compute", "rtf_compute_reciprocal"]
# Calls per differential window when a forward shape's device time is measured.
MEASURE_ITERS = 4


class Tester:
    """Evaluates ``generator`` on ``device`` (default the card; a CUDA device
    without CUDA raises). The generator is moved there. ``rows`` holds each
    clip's values, name and padded length after ``evaluate``."""

    def __init__(self, config, generator: torch.nn.Module, data_loader, logger=None,
                 output_dir: Optional[str] = None, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.generator = generator.to(self.device)
        self.loader = data_loader
        self.logger = logger or create_logger(config.OUTPUT)
        # TAG is `{input_sr}_{target_sr}` (reference base_tester.py:21-22).
        parts = config.TAG.split("_")
        self.input_sr = int(parts[0])
        self.target_sr = int(parts[1])
        self.num_frames_per_seg = int(config.DATA.SEGMENT * self.target_sr)
        self.output_dir = output_dir or config.OUTPUT
        os.makedirs(self.output_dir, exist_ok=True)
        self.forward = make_forward_fn(self.generator)
        self.metric_fns = get_metrics(config.TRAIN.METRICS)
        self.metrics = MetricTracker()
        self.compute_rtf = bool(config.TEST.get("COMPUTE_RTF", True))
        self._forward_dt: Dict = {}
        self.rows: List[Dict[str, float]] = []

    def _num_segments(self, t: int) -> int:
        return num_segments(t, self.num_frames_per_seg, self.config.TEST.OVERLAP)

    def _shape_keys(self, shape) -> set:
        """The forward shapes a clip of this shape runs: its bucket sizes if
        it is longer than a segment, else its own shape."""
        t = shape[-1]
        if t <= self.num_frames_per_seg:
            return {tuple(shape)}
        return set(segment_bucket_counts(self._num_segments(t)))

    def _measure_forward_dt(self, key) -> float:
        """Seconds per forward of one shape (a bucket size, or a
        single-segment clip's shape), each forward fed its own output."""
        from ..core.profiling import median_window_dt

        shape = key if isinstance(key, tuple) else (key, 1, self.num_frames_per_seg)
        x = torch.zeros(shape, dtype=torch.float32, device=self.device)
        hf = torch.full((shape[0],), self.target_sr // 4, dtype=torch.int64,
                        device=self.device)
        dt, _ = median_window_dt(lambda s: self.forward(s, hf), x, iters=MEASURE_ITERS)
        return dt

    def _compute_seconds(self, shape) -> float:
        """A clip's device seconds, from the measured times per forward
        (as ``bucketed_forward`` runs it)."""
        t = shape[-1]
        if t <= self.num_frames_per_seg:
            return self._forward_dt[tuple(shape)]
        return sum(self._forward_dt[b] * n for b, n in
                   segment_bucket_counts(self._num_segments(t)).items())

    def _forward_chunked(self, x: torch.Tensor, hf: torch.Tensor) -> torch.Tensor:
        """Chunked inference over segment buckets (reference tester.py:106-140)."""
        seg_len = self.num_frames_per_seg
        overlap = self.config.TEST.OVERLAP
        t = x.shape[-1]
        if t <= seg_len:
            return self.forward(x, hf)
        segments = unfold_audio(x, seg_len, overlap)  # (1, 1, S, seg)
        s = segments.shape[2]
        out = bucketed_forward(self.forward, segments.reshape(s, 1, seg_len), hf.expand(s))
        return fold_audio(out.reshape(1, 1, s, seg_len), t, seg_len, overlap)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def evaluate(self) -> Dict[str, float]:
        self.metrics = MetricTracker()
        self.rows = []
        self.logger.info(f"[TEST] {self.input_sr} → {self.target_sr} Hz, "
                         f"{len(self.loader)} files")
        warmed = set()
        for i, batch in enumerate(self.loader):
            dev = batch_to_device(batch, self.device)
            x, y, hf = dev["wave_input"], dev["wave_target"], dev["highcut"]
            keys = self._shape_keys(x.shape)
            if not keys <= warmed:
                # One untimed forward per new shape (cuDNN's and the
                # allocator's first-call costs), then its device time.
                self._forward_chunked(x, hf)
                self._sync()
                if self.compute_rtf:
                    for key in keys - warmed:
                        self._forward_dt[key] = self._measure_forward_dt(key)
                warmed |= keys
            pad = int(batch.pad_lengths[0])

            self._sync()
            t0 = time.perf_counter()
            wave_out = self._forward_chunked(x, hf)
            self._sync()
            run_time = time.perf_counter() - t0
            audio_seconds = (x.shape[-1] - pad) / self.config.DATA.TARGET_SR
            rtf = run_time / max(audio_seconds, 1e-9)

            with torch.no_grad():
                out_flat, y_flat = wave_out[:, 0, :], y[:, 0, :]
                vals = {name: float(fn(out_flat, y_flat, hf=hf))
                        for name, fn in self.metric_fns.items()}
                vals["rtf"] = rtf
                vals["rtf_reciprocal"] = 1.0 / rtf
                if self.compute_rtf:
                    rtf_c = self._compute_seconds(x.shape) / max(audio_seconds, 1e-9)
                    vals["rtf_compute"] = rtf_c
                    vals["rtf_compute_reciprocal"] = 1.0 / rtf_c
                if "lsd" in self.metric_fns:
                    vals["lsd_input"] = float(self.metric_fns["lsd"](x[:, 0, :], y_flat, hf=hf))
            for k, v in vals.items():
                self.metrics.update(k, v)
            self.rows.append(dict(vals, name=batch.names[0], samples=x.shape[-1]))

            if self.config.TEST.SAVE_RESULT:
                trim = x.shape[-1] - pad
                stem = batch.names[0].replace(".wav", "")
                sr = self.config.DATA.TARGET_SR
                for suffix, wave in (("up", wave_out), ("orig", y), ("down", x)):
                    save_wav(os.path.join(self.output_dir, f"{stem}_{suffix}.wav"),
                             wave[0, 0, :trim].float().cpu().numpy(), sr)

            if i % 10 == 0:
                self.logger.info(f"[TEST] {i + 1}/{len(self.loader)} "
                                 + " ".join(f"{k}={v:.4f}" for k, v in vals.items()))

        log = self.metrics.result()
        log["sample_rate"] = self.input_sr
        self.logger.info("[TEST] done: " + " ".join(f"{k}={v:.4f}" for k, v in log.items()))
        csv_name = "results_16kHz.csv" if self.target_sr == 16000 else "results_48kHz.csv"
        self.save_results_to_csv(log, filename=csv_name)
        return log

    @staticmethod
    def save_results_to_csv(results: Dict[str, float], filename: str) -> None:
        """Append a row in the reference's column order (reference
        tester.py:221-240), then the compute-RTF columns where measured."""
        cols = CSV_COLUMNS + [c for c in COMPUTE_COLUMNS if c in results]
        row = {k: results[k] for k in cols}
        exists = os.path.isfile(filename)
        with open(filename, "a", newline="") as f:
            writer = csv.writer(f)
            if not exists:
                writer.writerow([k.upper() for k in row])
            writer.writerow(row.values())
