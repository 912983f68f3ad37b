#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, and this repository around it; exits non-zero
before printing any result otherwise. Imports nothing of JAX. Phases, each
raising on failure:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: compile the CUDA kernels from vm_asr_tpu_torch/csrc with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the flagship 48 kHz forward gives it (batch 1; the fused scan
   also at batch 8, the largest segment bucket), with CUDA-event times
   beside the memory bound.
4. model: one flagship segment in fp32 through the generator with the
   kernels, and again with the scan routed to the plain versions.
5. serve: Inferencer.infer_file on three synthetic 16 kHz clips (tag
   16000_48000) with the full flagship generator (dims 16, depths 2-2-2-2,
   n_fft 1024, bf16 compute, seeded random weights), with launch counts.
6. the kernels line, the card line, and the result line.

Per-shape numbers also go to chiprun_out/chip_smoke/report.json.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from vm_asr_tpu_torch.core import default_config, load_config, update_config
from vm_asr_tpu_torch.dsp import num_segments, save_wav
from vm_asr_tpu_torch.models import SS2D, get_generator, set_scan_impl
from vm_asr_tpu_torch.models.ss2d import dt_bias_init_
from vm_asr_tpu_torch.ops import (
    linear_recurrence,
    linear_recurrence_plain,
    selective_scan_fused,
    selective_scan_fused_plain,
)
from vm_asr_tpu_torch.ops.build import build
from vm_asr_tpu_torch.train import Inferencer, segment_bucket_counts

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"
CONFIG = ROOT / "configs" / "vm_asr_48k_MPD.yaml"

# H100 SXM data sheet: HBM3 at 3.35 TB/s; 67 TFLOP/s fp32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per element: fused scan ~15 (softplus 6, exp, 2 muls for
# dt·A and dt·u·B, the recurrence's fma, y = C·h + D·u 3, decay product 1);
# linear recurrence 2 (one fma).
FUSED_OPS, LR_OPS = 15, 2

# Scan calls of one flagship forward (two streams; 512×512 image, embed to
# 128² × 16 channels, stages at 128², 64², 32², 16² with d_inner 32..256 so
# K·D = 128..1024; out_vss2 and out_vss3 run at 256² and 512² with K·D 64
# and 8). (L, K·D) → calls. Phase 4 checks these against the model's SS2Ds.
FUSED_CALLS = {(16384, 128): 6, (4096, 256): 8, (1024, 512): 8, (256, 1024): 8}
LR_CALLS = {(65536, 64): 2, (262144, 8): 2}
K = 4

# Kernel vs plain tolerances, elementwise |kernel - plain| <= atol + rtol·|plain|:
# fp32: the two scans associate the recurrence differently (chunked carry vs
# doubling); the JAX package's kernel bar (tests/test_fused_scan.py:29-30).
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 outputs: both compute in fp32 and round once; results ~1e-7 apart can
# round to neighbouring bf16 values, one ulp ≤ 2^-7 of the value.
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
# Whole model, fp32, kernels vs plain scan, max |diff| / max |plain|: the
# scans' ~1e-7 differences pass through 34 scans, LayerNorms and the
# log-magnitude exp2 (8.0e-7 measured on an H100); a wrong kernel moves the
# output by O(1).
MODEL_REL_TOL = 1e-5


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, per: int = 20) -> float:
    """Median over ``reps`` windows of ``per`` back-to-back calls, in ms per
    call, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def device_kernels(fn, n: int = 1):
    """The device events (kernels, copies) of ``n`` calls of ``fn`` under
    torch.profiler, as (name, start_us, end_us), after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_ms(fn, n: int = 10):
    """Device time of one call (kernels only, no launch gaps), in ms; None if
    the profiler recorded no device events."""
    events = device_kernels(fn, n)
    return busy_us(events) / n / 1e3 if events else None


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def init_ranges(kd: int, gen: torch.Generator):
    """A, dt_bias and D_skip as the model initialises them (A_logs = log 1,
    dt ~ LogUniform(0.001, 0.1), D = 1), on the card."""
    bias = dt_bias_init_(torch.empty(kd), gen)
    return (-torch.ones(kd).cuda(), bias.cuda(), torch.ones(kd).cuda())


def check_close(name, got, ref, tol):
    ok = torch.allclose(got.float(), ref.float(), **tol)
    err = (got.float() - ref.float()).abs().max().item()
    if not ok:
        raise AssertionError(f"{name}: kernel vs plain max |diff| {err:.3e} outside {tol}")
    return err


def check_fused(batch, l, kd, dtype, gen):
    g = torch.Generator(device="cuda").manual_seed(batch * 1_000_003 + l * 1009 + kd)
    a, bias, dsk = init_ranges(kd, gen)
    u = torch.randn(batch, l, kd, device="cuda", generator=g).to(dtype)
    dts = (0.5 * torch.randn(batch, l, kd, device="cuda", generator=g)).to(dtype)
    bs = torch.randn(batch, l, K, device="cuda", generator=g).to(dtype)
    cs = torch.randn(batch, l, K, device="cuda", generator=g).to(dtype)
    args = (u, dts, bs, cs, a, bias, dsk, K)
    y = selective_scan_fused(*args)
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    err = check_close(f"fused {(batch, l, kd)} {dtype}", y, selective_scan_fused_plain(*args), tol)
    size = u.element_size()
    nbytes = (3 * batch * l * kd + 2 * batch * l * K) * size + 3 * kd * 4
    bms, by = bound_ms(nbytes, FUSED_OPS * batch * l * kd)
    return dict(kernel="selective_scan_fused", shape=[batch, l, kd], dtype=str(dtype),
                max_abs_err=err, tol=tol, bytes=nbytes,
                ms=cuda_ms(lambda: selective_scan_fused(*args)),
                device_ms=device_ms(lambda: selective_scan_fused(*args)),
                plain_ms=cuda_ms(lambda: selective_scan_fused_plain(*args), reps=3, per=3),
                bound_ms=bms, bound_by=by)


def check_lr(rows, l, d, gen):
    g = torch.Generator(device="cuda").manual_seed(rows * 1_000_003 + l * 1009 + d)
    _, bias, _ = init_ranges(d, gen)
    dt = torch.nn.functional.softplus(
        0.5 * torch.randn(rows, l, d, device="cuda", generator=g) + bias)
    a = torch.exp(-dt)
    b = dt * torch.randn(rows, l, d, device="cuda", generator=g)
    h = linear_recurrence(a, b)
    torch.cuda.synchronize()
    err = check_close(f"linear_recurrence {(rows, l, d)}", h, linear_recurrence_plain(a, b),
                      FP32_TOL)
    nbytes = 3 * rows * l * d * 4
    bms, by = bound_ms(nbytes, LR_OPS * rows * l * d)
    return dict(kernel="linear_recurrence", shape=[rows, l, d], dtype="torch.float32",
                max_abs_err=err, tol=FP32_TOL, bytes=nbytes,
                ms=cuda_ms(lambda: linear_recurrence(a, b)),
                device_ms=device_ms(lambda: linear_recurrence(a, b)),
                plain_ms=cuda_ms(lambda: linear_recurrence_plain(a, b), reps=3, per=3),
                bound_ms=bms, bound_by=by)


def flagship_config(amp: bool):
    opts = ["TRAIN.ADVERSARIAL.ENABLE", "False", "AMP_ENABLE", str(amp),
            "OUTPUT", str(OUT / "logs"), "TAG", "16000_48000",
            "INFERENCE.RESULTS_DIR", str(OUT / "results")]
    have_yaml = importlib.util.find_spec("yaml") is not None
    if have_yaml:
        c = load_config(str(CONFIG), opts)
    else:
        # No PyYAML: the port's defaults plus the overrides of
        # configs/vm_asr_48k_MPD.yaml that bear on the generator.
        c = default_config()
        c.MODEL.NAME = "DualStreamInteractiveMambaUNet"
        c.MODEL.VSSM.DIMS = 16
        c.DATA.TARGET_SR = 48000
        c.TRAIN.LOW_FREQ_REPLACEMENT = True
        c.merge_from_list(opts)
        update_config(c, argparse.Namespace())
    print(f"config: {CONFIG.name} {'via PyYAML' if have_yaml else 'as defaults + overrides'}")
    v = c.MODEL.VSSM
    want = (c.MODEL.NAME, v.DIMS, list(v.DEPTHS), v.SSM_D_STATE, c.DATA.TARGET_SR,
            c.DATA.STFT.N_FFT, c.DATA.STFT.HOP_LENGTH, c.DTYPE.COMPUTE)
    assert want == ("DualStreamInteractiveMambaUNet", 16, [2, 2, 2, 2], 1, 48000,
                    1024, 240, "bfloat16"), want
    return c


def speech_like(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Harmonic "voice" with a wandering pitch, syllable envelope and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6))
    phase_ = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase_) / k for k in range(1, 30) if k * 150 < sr / 2)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    x = 0.25 * x * env / np.abs(x).max() + 0.01 * rng.standard_normal(t.size)
    return x.astype(np.float32)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the card",
              file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    report = {}

    t0 = phase("device")
    smi = nvidia_smi_line()
    print(smi)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    report["device"] = dict(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = phase("build")
    built = build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s (nvcc, in parallel)")
    report["build_s"] = time.perf_counter() - t0

    t0 = phase("kernels vs plain, every main-path shape")
    gen = torch.Generator().manual_seed(0)
    checks = []
    for batch in (1, 8):
        for (l, kd) in FUSED_CALLS:
            for dtype in (torch.bfloat16, torch.float32):
                checks.append(check_fused(batch, l, kd, dtype, gen))
    for (l, d) in LR_CALLS:
        checks.append(check_lr(1, l, d, gen))
    for c in checks:
        print(f"{c['kernel']} {tuple(c['shape'])} {c['dtype'][6:]}: max|err| "
              f"{c['max_abs_err']:.3e} (tol {c['tol']}) kernel {c['ms']:.4f} ms "
              f"(device {fmt_ms(c['device_ms'])}), plain "
              f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']}, "
              f"{c['bytes'] / 1e6:.2f} MB)")
    report["kernel_checks"] = checks
    print(f"kernels checked in {time.perf_counter() - t0:.1f} s")

    t0 = phase("model: fp32 flagship segment, kernels vs plain scan")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    # TF32 off for both: fp32 matmuls and cuDNN convolutions in full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = flagship_config(amp=False)
    model = get_generator(cfg32, "cuda")
    seg = int(cfg32.DATA.SEGMENT * cfg32.DATA.TARGET_SR)
    x = torch.from_numpy(speech_like(seg / 48000, 48000, seed=1)[None, None]).cuda()
    hf = torch.tensor([171], device="cuda")
    seen = Counter()
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.update([(inp[0].shape[1] * inp[0].shape[2], K * mod.d_inner)]))
        for m in model.modules() if isinstance(m, SS2D)]
    with torch.inference_mode():
        y_kernel = model(x, hf)
        for h in hooks:
            h.remove()
        set_scan_impl(model, "plain")
        y_plain = model(x, hf)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    expected = Counter({**FUSED_CALLS, **LR_CALLS})
    if seen != expected:
        raise AssertionError(f"scan shapes of the forward {dict(seen)} != {dict(expected)}")
    rel = ((y_kernel - y_plain).abs().max() / y_plain.abs().max()).item()
    finite = bool(torch.isfinite(y_kernel).all())
    print(f"output {tuple(y_kernel.shape)}, finite {finite}; max|kernel - plain| / "
          f"max|plain| = {rel:.3e} (tol {MODEL_REL_TOL}); TF32 off")
    if not finite or y_kernel.shape != x.shape or not rel <= MODEL_REL_TOL:
        raise AssertionError("model check failed")
    report["model_check"] = dict(rel_err=rel, tol=MODEL_REL_TOL)
    del model, y_kernel, y_plain
    print(f"model checked in {time.perf_counter() - t0:.1f} s")

    t0 = phase("serve: Inferencer.infer_file, full flagship generator, bf16")
    cfg = flagship_config(amp=True)
    model = get_generator(cfg, "cuda")
    inferencer = Inferencer(cfg, model, output_dir=str(OUT / "results"), device="cuda")
    seg = inferencer.num_frames_per_seg
    clips = {"short_1.2s": 1.2, "one_segment_2.555s": 2.555, "long_7.5s": 7.5}
    paths = {}
    for i, (name, sec) in enumerate(clips.items()):
        paths[name] = str(OUT / f"{name}.wav")
        save_wav(paths[name], speech_like(sec, 16000, seed=10 + i), 16000)

    def serve(name):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inferencer.infer_file(paths[name], quiet=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    cold = {name: serve(name)[1] for name in clips}  # first calls: set-up
    selective_scan_fused.launches = 0
    linear_recurrence.launches = 0
    requests, forwards = [], 0
    for name, sec in clips.items():
        f0, l0 = selective_scan_fused.launches, linear_recurrence.launches
        out, wall = serve(name)
        n_in = int(round(sec * 48000))
        n_pad = seg if n_in <= seg else -(-n_in // seg) * seg
        n_seg = num_segments(n_pad, seg, cfg.INFERENCE.OVERLAP) if n_pad > seg else 1
        n_fwd = sum(segment_bucket_counts(n_seg).values())
        d_fused = selective_scan_fused.launches - f0
        d_lr = linear_recurrence.launches - l0
        ok = bool(torch.isfinite(out).all()) and out.shape == (1, 1, n_pad)
        r = dict(name=name, audio_s=sec, wall_s=wall, rtf=wall / sec, cold_wall_s=cold[name],
                 forwards=n_fwd, fused_launches=d_fused, lr_launches=d_lr,
                 out_samples=out.shape[-1], finite_and_length_ok=ok)
        print(json.dumps(r))
        if not ok or d_fused != 30 * n_fwd or d_lr != 4 * n_fwd:
            raise AssertionError(f"serve {name}: {r}")
        requests.append(r)
        forwards += n_fwd
    launches = dict(selective_scan_fused=selective_scan_fused.launches,
                    linear_recurrence=linear_recurrence.launches)
    print(f"serve: {len(requests)} requests, {forwards} forwards, launches {launches}")
    report["serve"] = requests
    print(f"served in {time.perf_counter() - t0:.1f} s")

    t0 = phase("profile: one batch-1 forward, bf16")
    x = torch.from_numpy(speech_like(seg / 48000, 48000, seed=2)[None, None]).cuda()
    hf = torch.tensor([inferencer.load_input(paths["one_segment_2.555s"])[1].item()],
                      device="cuda")
    fwd = lambda: inferencer.forward(x, hf)
    wall_ms = cuda_ms(fwd, reps=5, per=1)
    events = device_kernels(fwd)
    busy = busy_us(events) / 1e3
    by_name = Counter()
    for name, s_, e_ in events:
        by_name[name] += (e_ - s_) / 1e3
    scan_ms = sum(t for name, t in by_name.items()
                  if "chunk_kernel" in name or "chunk_carry" in name)
    prof = dict(wall_ms=wall_ms, device_busy_ms=busy if events else None,
                device_events=len(events), scan_kernels_ms=scan_ms,
                idle_share=(1 - busy / wall_ms) if events else None,
                top=[(n, t) for n, t in by_name.most_common(8)])
    idle = "not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.3f}"
    print(f"forward: wall {wall_ms:.2f} ms, device busy {fmt_ms(prof['device_busy_ms'])} "
          f"in {len(events)} device events, scan kernels {scan_ms:.3f} ms, idle share {idle}")
    for n, t in prof["top"]:
        print(f"  {t:8.3f} ms  {n[:100]}")
    report["profile"] = prof
    print(f"profiled in {time.perf_counter() - t0:.1f} s")

    def entry(name, route_src, replaces, calls, dtype):
        rows = [c for c in checks if c["kernel"] == name]
        at_b1 = {tuple(c["shape"][1:]): c for c in rows
                 if c["shape"][0] == 1 and c["dtype"] == dtype}
        per_fwd = lambda key: sum(n * at_b1[s][key] for s, n in calls.items())
        return dict(name=name, route="cuda", source=route_src, replaces=replaces,
                    launches=launches[name],
                    max_abs_err=max(c["max_abs_err"] for c in rows),
                    ms=per_fwd("ms"), plain_ms=per_fwd("plain_ms"),
                    device_ms=None if any(at_b1[k]["device_ms"] is None for k in calls)
                    else per_fwd("device_ms"),
                    bound_ms=per_fwd("bound_ms"), bound_by="bytes", library_ms=None,
                    check="pass", per="one batch-1 forward, summed over its calls")

    kernels = [
        entry("selective_scan_fused", "vm_asr_tpu_torch/csrc/fused_scan.cu",
              "vm_asr_tpu/ops/selective_scan_fused.py:141", FUSED_CALLS, "torch.bfloat16"),
        entry("linear_recurrence", "vm_asr_tpu_torch/csrc/linear_recurrence.cu",
              "vm_asr_tpu/ops/linear_recurrence.py:172", LR_CALLS, "torch.float32"),
    ]
    if any(c["bound_by"] != "bytes" for c in checks):
        raise AssertionError("a kernel check came out operation-bound; update bound_by")
    report["kernels"] = kernels
    (OUT / "report.json").write_text(json.dumps(report, indent=1))

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
