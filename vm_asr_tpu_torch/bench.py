"""Benchmark: the flagship 48 kHz generator's inference and training
throughput on one card, and the fused scan against the HBM roofline (the
port of the JAX package's bench.py).

    python -m vm_asr_tpu_torch.bench [--device cuda|cpu]

Prints one JSON line a metric:

- ``rtf_reciprocal_48k_batch1``: audio seconds over device seconds for one
  2.555 s segment at batch 1 (bf16 compute, ``torch.no_grad``), the
  reference's RTF_RECIPROCAL column;
- ``rtf_reciprocal_48k_batch1_stacked``: the same through the
  stream-stacked generator (``models.to_stacked``);
- ``rtf_reciprocal_48k_fullclip_device``: a clip of three overlapping
  segments, unfolded, run at batch 3 and folded back, all on the device;
- ``rtf_reciprocal_48k_batch32``: batch 32, with ``mfu_pct_h100_bf16``:
  ``core.profiling.matmul_flops`` of the forward over the time, as a share
  of the card's dense bf16 tensor-core peak;
- ``train_rt_factor_48k_MPD_batch8``: audio seconds trained per second by
  the port's Trainer step (generator, MPD, AdamW ×2; FUSE_STREAMS on) at
  batch 8, with the step's phases from the spans of its profiled call:
  ``phase_ms``, host ms a step by phase, and ``phase_idle_ms``, the
  device's idle ms a step by the innermost phase open;
- ``scan_fwd_hbm_roofline_pct`` and ``scan_fwd_bwd_hbm_roofline_pct``: the
  fused scan (the autograd Function of the main path) at (8, 16384, 128)
  bf16, ``scan_roofline_bytes`` over the time as a share of the card's HBM
  bandwidth.

Timing: ``core.profiling.median_window_dt`` (differential windows, CUDA
events on a card), each call chained to the previous one's output so that
every call is distinct and its output consumed, after the JAX bench's
warm-up calls. Beside each line's wall figure: ``device_busy_ms`` (the
union of the device's kernel and copy intervals in one profiled call, or
a call's share of a profiled window of at least 20 ms; the CPU is profiled
too, for the spans) and
``idle_share`` (1 − busy ÷ the timed wall), the card's ``device`` name and
``power_limit_w`` (nvidia-smi), and ``peak_memory_gb``
(``torch.cuda.max_memory_allocated`` over the stage).

The peaks are a table keyed by the card's name (``PEAKS``): an unlisted
card raises, and a share over 100 % raises. On the CPU (``--device cpu``)
there is no peak and no profile of a device: those keys are null. A failed
stage prints its traceback, the others still run, and the process exits 1.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .core import default_config
from .core.device import resolve_device
from .core.profiling import (
    busy_ns,
    clear_spans,
    device_intervals,
    idle_by_span,
    matmul_flops,
    median_window_dt,
    recorded_spans,
)
from .dsp import fold_audio, unfold_audio

# Dense (no sparsity) bf16 tensor-core FLOP/s and HBM bytes/s by the card's
# name as torch.cuda.get_device_name gives it. NVIDIA H100 Tensor Core GPU
# datasheet, H100 SXM5: 989.4 TFLOP/s bf16 dense, 3.35 TB/s HBM3.
# ``label`` names the card in the metric keys and units.
PEAKS = {"NVIDIA H100 80GB HBM3": {"label": "h100", "bf16_flops": 989.4e12,
                                   "hbm_bytes_per_s": 3.35e12}}

K = 4
# The least device time a busy-time capture spans (timed).
PROFILE_WINDOW_S = 0.02

_QUIET = logging.getLogger("vm_asr_tpu_torch.bench")
_QUIET.addHandler(logging.NullHandler())
_QUIET.propagate = False


def flagship_config(segment_seconds: float = 2.555, batch_size: int = 1, gan: bool = False):
    """The flagship 48 kHz configuration the bench measures: the defaults
    with DualStreamInteractiveMambaUNet at DIMS 16, 48 kHz, hop 240,
    LOW_FREQ_REPLACEMENT and, with ``gan``, the MPD (the JAX package's
    __graft_entry__._flagship_config)."""
    c = default_config()
    c.MODEL.NAME = "DualStreamInteractiveMambaUNet"
    c.MODEL.VSSM.DIMS = 16
    c.DATA.TARGET_SR = 48000
    c.DATA.STFT.HOP_LENGTH = 240
    c.DATA.SEGMENT = segment_seconds
    c.DATA.BATCH_SIZE = batch_size
    c.TRAIN.LOW_FREQ_REPLACEMENT = True
    c.TRAIN.ADVERSARIAL.ENABLE = gan
    c.TRAIN.ADVERSARIAL.DISCRIMINATORS = ["mpd"] if gan else [""]
    c.TENSORBOARD.ENABLE = False
    return c


@dataclass
class Card:
    """Where the bench runs: the device, its name and power limit as
    nvidia-smi gives them, and its peaks (None on the CPU)."""

    device: torch.device
    name: str
    power_limit_w: Optional[float]
    peaks: Optional[dict]

    @property
    def label(self) -> str:
        return self.peaks["label"] if self.peaks else self.device.type

    @classmethod
    def probe(cls, device="cuda") -> "Card":
        dev = resolve_device(device)
        if dev.type != "cuda":
            return cls(dev, "cpu", None, None)
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        name = torch.cuda.get_device_name(index)
        if name not in PEAKS:
            raise KeyError(f"no peaks listed for {name!r}; add its datasheet figures to PEAKS")
        r = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
        smi_name, power = (s.strip() for s in r.stdout.strip().splitlines()[0].split(","))
        return cls(torch.device("cuda", index), smi_name, float(power.split()[0]), PEAKS[name])

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def share(self, rate: float, peak: str) -> Optional[float]:
        """``rate`` as a percentage of the peak ``peak``; raises over 100 %."""
        if self.peaks is None:
            return None
        pct = 100.0 * rate / self.peaks[peak]
        if not 0.0 < pct <= 100.0:
            raise ValueError(f"{pct:.2f} % of the {self.name}'s {peak} peak is an impossible "
                             f"reading")
        return pct

    def reset_memory(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_memory_gb(self) -> Optional[float]:
        return torch.cuda.max_memory_allocated(self.device) / 1e9 if self.cuda else None


@dataclass
class Profile:
    """One profiled run of a stage's call: the device busy ms a call (None on
    the CPU), and, by name of the program's spans recorded in it, host ms a
    call (``phase_ms``) and the device's idle ms a call by the innermost
    span open (``phase_idle_ms``; None on the CPU)."""

    busy_ms: Optional[float]
    phase_ms: Dict[str, float]
    phase_idle_ms: Optional[Dict[str, float]]


def profile_calls(fn: Callable[[], object], card: Card, calls: int = 1) -> Profile:
    """``calls`` back-to-back calls of ``fn`` under torch.profiler: busy time
    is the union of their kernels' and copies' intervals (annotations left
    out), over ``calls``. Raises on the card when the capture holds no
    device event."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if card.cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(card.device)
    clear_spans()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.time_ns()
        for _ in range(calls):
            fn()
        if card.cuda:
            torch.cuda.synchronize(card.device)
        t1 = time.time_ns()
    spans = recorded_spans()
    clear_spans()
    phase_ms: Dict[str, float] = {}
    for s in spans:
        phase_ms[s.name] = phase_ms.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6 / calls
    if not card.cuda:
        return Profile(None, phase_ms, None)
    events = device_intervals(prof)
    if not events:
        raise RuntimeError(f"the profiler saw no device event in {calls} calls on the card")
    idle = {k: v / 1e6 / calls for k, v in idle_by_span(events, spans, t0, t1).items()}
    return Profile(busy_ns(events) / 1e6 / calls, phase_ms, idle)


def timed(card: Card, step: Callable, state, warmup: int, iters: int):
    """(seconds a call, ``Profile``, last state) of the chained
    ``state = step(state)``: ``warmup`` calls, the differential windows of
    ``median_window_dt``, then one profiled call, or as many calls as fill
    PROFILE_WINDOW_S where a call is shorter (the profiler can miss every
    event of a sub-millisecond capture)."""
    for _ in range(warmup):
        state = step(state)
    if card.cuda:
        torch.cuda.synchronize(card.device)
    dt, state = median_window_dt(step, state, iters=iters)
    calls = max(1, math.ceil(PROFILE_WINDOW_S / dt))
    return dt, profile_calls(lambda: step(state), card, calls), state


def line(card: Card, metric: str, value: float, unit: str, dt: float,
         busy: Optional[float], iters: int, **extra) -> dict:
    """One metric line with the fields every line carries."""
    record = {"metric": metric, "value": value, "unit": unit,
              "ms_per_call": dt * 1e3, "device_busy_ms": busy,
              "idle_share": None if busy is None else 1.0 - busy / (dt * 1e3),
              "device": card.name, "power_limit_w": card.power_limit_w,
              "peak_memory_gb": card.peak_memory_gb(), "iters": iters,
              "timing": "cuda_events_diff" if card.cuda else "host_clock_diff"}
    record.update(extra)
    return record


def _rtf_line(card, metric, audio_s, dt, busy, iters, **extra):
    return line(card, metric, audio_s / dt, "x_realtime", dt, busy, iters, **extra)


def _segment(config) -> int:
    return int(config.DATA.SEGMENT * config.DATA.TARGET_SR)


def _highcut(card: Card, config, batch: int) -> torch.Tensor:
    """The 16 kHz → TARGET_SR task's highcut bin (171 at 48 kHz, n_fft 1024)."""
    hf = int((1 + config.DATA.STFT.N_FFT // 2) * 16000 / config.DATA.TARGET_SR)
    return torch.full((batch,), hf, dtype=torch.int64, device=card.device)


def _wave(card: Card, shape, seed: int) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.1
    return torch.from_numpy(x).to(card.device)


def _chained(generator: torch.nn.Module, hf: torch.Tensor) -> Callable:
    """x → x + 1e-6·generator(x, hf): each call distinct, its output used."""
    def step(x):
        with torch.no_grad():
            return x + 1e-6 * generator(x, hf)
    return step


def bench_batch1(card: Card, generator, config, warmup: int = 40, iters: int = 20) -> dict:
    """The headline: batch 1, one segment (bench.py:_inference_stages)."""
    card.reset_memory()
    x = _wave(card, (1, 1, _segment(config)), seed=0)
    hf = _highcut(card, config, 1)
    dt, prof, _ = timed(card, _chained(generator, hf), x, warmup, iters)
    return _rtf_line(card, "rtf_reciprocal_48k_batch1", config.DATA.SEGMENT, dt, prof.busy_ms,
                     iters)


def bench_stacked(card: Card, generator, config, warmup: int = 40, iters: int = 20) -> dict:
    """Batch 1 through the stream-stacked generator, which runs each op
    once for both streams (bench.py:bench_stacked)."""
    from .models import to_stacked

    config = config.clone()
    config.MODEL.VSSM.STACKED_EXECUTION = True
    stacked = to_stacked(config, generator)
    if stacked is generator:
        raise RuntimeError("the configuration has no stacked generator")
    card.reset_memory()
    x = _wave(card, (1, 1, _segment(config)), seed=0)
    hf = _highcut(card, config, 1)
    dt, prof, _ = timed(card, _chained(stacked, hf), x, warmup, iters)
    return _rtf_line(card, "rtf_reciprocal_48k_batch1_stacked", config.DATA.SEGMENT, dt,
                     prof.busy_ms, iters)


def bench_full_clip(card: Card, generator, config, n_segments: int = 3, warmup: int = 20,
                    iters: int = 10) -> dict:
    """A whole clip on the device: unfold into ``n_segments`` overlapping
    segments (TEST.OVERLAP), one forward at that batch, fold back with the
    overlaps averaged (bench.py:bench_full_clip; the Tester's path without
    the host). The clip's length tiles the windows exactly."""
    seg, overlap = _segment(config), int(config.TEST.OVERLAP)
    t = seg + (n_segments - 1) * (seg - overlap)
    card.reset_memory()
    x = _wave(card, (1, 1, t), seed=2)
    hf = _highcut(card, config, n_segments)

    def step(x):
        with torch.no_grad():
            segments = unfold_audio(x, seg, overlap).reshape(n_segments, 1, seg)
            out = generator(segments, hf).reshape(1, 1, n_segments, seg)
            return x + 1e-6 * fold_audio(out, t, seg, overlap)

    dt, prof, _ = timed(card, step, x, warmup, iters)
    audio_s = t / config.DATA.TARGET_SR
    return _rtf_line(card, "rtf_reciprocal_48k_fullclip_device", audio_s, dt, prof.busy_ms, iters,
                     clip_seconds=audio_s, n_segments=n_segments)


def bench_batched(card: Card, generator, config, batch: int = 32, warmup: int = 30,
                  iters: int = 20) -> dict:
    """Batched serving and its tensor-core utilisation
    (bench.py:bench_batched): ``matmul_flops`` of one forward, the
    products' and convolutions' FLOPs counted from their shapes in the JAX
    package's convention, over the time, as a share of the card's dense
    bf16 peak."""
    card.reset_memory()
    x = _wave(card, (batch, 1, _segment(config)), seed=1)
    hf = _highcut(card, config, batch)
    with torch.no_grad():
        flops = matmul_flops(generator, x, hf)
    dt, prof, _ = timed(card, _chained(generator, hf), x, warmup, iters)
    rate = flops / dt
    return _rtf_line(card, f"rtf_reciprocal_48k_batch{batch}", batch * config.DATA.SEGMENT,
                     dt, prof.busy_ms, iters, segments_per_s=batch / dt, matmul_flops=flops,
                     tensor_tflops=rate / 1e12,
                     **{f"mfu_pct_{card.label}_bf16": card.share(rate, "bf16_flops")})


def train_config(batch_size: int = 8):
    """The training stage's configuration: the flagship with the MPD at
    ``batch_size`` with FUSE_STREAMS on (the decoders of both streams in one
    pass, the same per-sample math), as bench.py:bench_train measures it."""
    c = flagship_config(batch_size=batch_size, gan=True)
    c.MODEL.VSSM.FUSE_STREAMS = True
    return c


def bench_train(card: Card, batch_size: int = 8, warmup: int = 10, iters: int = 10,
                config_fn: Callable = train_config) -> dict:
    """The GAN train step of the port's Trainer (``config_fn(batch_size)``)
    on one batch of its synthetic corpus, the models' states updated in
    place by every step, so that each step is distinct and consumes the last
    (bench.py:bench_train), with the phase split of its profiled call."""
    from .data import DataPipeline, DegradingSampler, SyntheticVCTK
    from .data.pipeline import batch_to_device
    from .models import get_discriminators, get_generator
    from .train import Trainer

    card.reset_memory()
    config = config_fn(batch_size)
    ds = SyntheticVCTK(n_items=batch_size, sr=config.DATA.TARGET_SR,
                       duration=config.DATA.SEGMENT + 0.01)
    loader = DataPipeline(DegradingSampler(ds, config, training=True), batch_size=batch_size,
                          num_workers=2)
    models = {"generator": get_generator(config, card.device),
              **get_discriminators(config, card.device)}
    with tempfile.TemporaryDirectory(prefix="vm_asr_bench_") as out:
        config = config.clone()
        config.OUTPUT = out  # the Trainer's checkpoint directory; nothing is written
        trainer = Trainer(config, models, loader, None, logger=_QUIET)
    device_batch = batch_to_device(next(iter(loader)), card.device)
    rng = torch.Generator(device=card.device).manual_seed(config.SEED)

    def step(_):
        trainer.gen_state, trainer.disc_states, metrics = trainer.train_step(
            trainer.gen_state, trainer.disc_states, device_batch, rng)
        return metrics["total_loss"]

    dt, prof, loss = timed(card, step, torch.zeros((), device=card.device), warmup, iters)
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(f"non-finite training loss {float(loss)}")
    return line(card, f"train_rt_factor_48k_MPD_batch{batch_size}",
                batch_size * config.DATA.SEGMENT / dt, "x_realtime", dt, prof.busy_ms, iters,
                fuse_streams=True, phase_ms=prof.phase_ms, phase_idle_ms=prof.phase_idle_ms)


def scan_roofline_bytes(batch: int, l: int, kd: int, k: int = K, itemsize: int = 2,
                        chunk: Optional[int] = None) -> Dict[str, int]:
    """HBM bytes one chained call of the roofline stage must move, forward
    and forward + backward (the least traffic of the function timed, each
    input read once and each output written once):

    - forward: u and dts read, y written, and the chain's mean of y read
      (4 (B, L, K·D) passes of ``itemsize`` bytes); B and C read (2
      (B, L, K) passes); the chunk-entry states H0 written, fp32, one per
      (row, L-chunk, channel);
    - forward + backward: the forward's 3 passes and H0; dy = ones written
      (1); the backward kernel's u, dts and dy read and du, ddts written
      (5) and H0 read; the chain's mean of du read (1): 10 passes and H0
      twice; B and C read by both kernels and dB, dC written (6 (B, L, K)
      passes).

    ``chunk`` defaults to the port kernels' own L-chunk at this shape
    (``ops.selective_scan_fused.chunk_length``), so H0 is what the forward
    kernel writes. The JAX bench (bench.py:486-493) counts the same
    (B, L, K·D) passes, H0 at its own chunk (256 or 512), and 12 (B, L, K)
    passes in forward + backward where the port's kernels move 6: both read
    B and C in each kernel (4), but JAX adds fp32 casts of B and C (4) and
    writes dB and dC in fp32 (4), where the port writes them in the IO
    dtype (2). The (A, dt_bias, D) vectors (K·D fp32 each) are left out on
    both sides. Bytes ÷ the HBM rate is the "Bound ms" yardstick of PERF.md's
    kernel table; that table counts one kernel call, without the chain's
    read or the ones."""
    from .ops.selective_scan_fused import chunk_length

    chunk = chunk or chunk_length(batch, l, kd)
    kd_pass = batch * l * kd * itemsize
    k_pass = batch * l * k * itemsize
    h0 = batch * (-(-l // chunk)) * kd * 4
    return {"fwd": 4 * kd_pass + 2 * k_pass + h0,
            "fwd_bwd": 10 * kd_pass + 2 * h0 + 6 * k_pass}


def scan_inputs(card: Card, batch: int, l: int, kd: int, dtype=torch.bfloat16):
    """The roofline stage's seeded inputs (bench.py:bench_scan_roofline's
    distributions): u, dts, bs, cs in ``dtype``, A, dt_bias, D in fp32."""
    rng = np.random.default_rng(0)

    def t(a, dt):
        return torch.from_numpy(np.asarray(a, np.float32)).to(card.device, dt)

    return dict(u=t(rng.standard_normal((batch, l, kd)), dtype),
                dts=t(rng.standard_normal((batch, l, kd)) * 0.1, dtype),
                bs=t(rng.standard_normal((batch, l, K)), dtype),
                cs=t(rng.standard_normal((batch, l, K)), dtype),
                a_neg=t(-np.exp(rng.standard_normal(kd) * 0.1), torch.float32),
                dt_bias=t(rng.standard_normal(kd) * 0.01, torch.float32),
                d_skip=t(rng.standard_normal(kd), torch.float32))


def bench_scan_roofline(card: Card, batch: int = 8, l: int = 16384, kd: int = 128,
                        warmup: int = 10, iters: int = 20) -> list:
    """The fused scan at the flagship's first stage in training (batch 8,
    L = 16 384, K·D = 128, bf16 IO), forward and forward + backward through
    the autograd Function the model calls, each chained through B by the
    mean of its output; the bytes of ``scan_roofline_bytes`` over the time,
    as a share of the card's HBM bandwidth (bench.py:bench_scan_roofline)."""
    from .ops import selective_scan_fused

    s = scan_inputs(card, batch, l, kd)
    u = s["u"].requires_grad_(True)
    dts = s["dts"].requires_grad_(True)

    def scan(bs):
        return selective_scan_fused(u, dts, bs, s["cs"], s["a_neg"], s["dt_bias"], s["d_skip"], K)

    def fwd(bs):
        with torch.no_grad():
            return bs + (1e-6 * scan(bs).float().mean()).to(bs.dtype)

    def fwd_bwd(bs):
        y = scan(bs)
        du, _ = torch.autograd.grad(y, (u, dts), grad_outputs=torch.ones_like(y))
        return bs + (1e-6 * du.float().mean()).to(bs.dtype)

    nbytes = scan_roofline_bytes(batch, l, kd)
    peak = card.peaks["hbm_bytes_per_s"] if card.peaks else None
    records = []
    for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        card.reset_memory()
        dt, prof, _ = timed(card, fn, s["bs"], warmup, iters)
        rate = nbytes[name] / dt
        pct = card.share(rate, "hbm_bytes_per_s")
        unit = f"pct_of_{card.label}" + (f"_{peak / 1e9:.0f}GBs" if peak else "")
        records.append(line(card, f"scan_{name}_hbm_roofline_pct", pct, unit, dt, prof.busy_ms,
                            iters,
                            eff_gbs=rate / 1e9, bytes=nbytes[name],
                            shape=f"({batch},{l},{kd})_bf16"))
    return records


class StagesFailed(RuntimeError):
    """One or more stages of ``run`` failed (each printed its traceback)."""


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def run(card: Card, inference: Optional[dict] = None, train: Optional[dict] = None,
        scan: Optional[dict] = None, config=None) -> list:
    """Every stage at the JAX bench's defaults, or with the keyword
    arguments given for its group (``inference``: warm-up and iterations of
    the four inference stages, by stage name; ``train``; ``scan``), on
    ``config``'s generator (default the flagship's). Prints each line as it
    comes; a failed stage prints its traceback and the others still run.
    Returns the lines, and raises at the end if a stage failed."""
    from .models import get_generator

    config = config or flagship_config()
    inference = inference or {}
    lines, failed = [], []

    def stage(name, fn, *args, **kwargs):
        try:
            out = fn(card, *args, **kwargs)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            failed.append(name)
            return
        for record in out if isinstance(out, list) else [out]:
            emit(record)
            lines.append(record)

    try:
        generator = get_generator(config, card.device)
    except Exception:
        traceback.print_exc(file=sys.stderr)
        failed.append("generator")
        generator = None
    if generator is not None:
        for name, fn in (("batch1", bench_batch1), ("stacked", bench_stacked),
                         ("fullclip", bench_full_clip), ("batched", bench_batched)):
            stage(name, fn, generator, config, **inference.get(name, {}))
        del generator
    stage("train", bench_train, **(train or {}))
    stage("scan", bench_scan_roofline, **(scan or {}))
    if failed:
        raise StagesFailed(f"bench stages failed: {failed}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    card = Card.probe(args.device)
    try:
        run(card)
    except StagesFailed as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
