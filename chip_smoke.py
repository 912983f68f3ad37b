#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, and this repository around it; exits non-zero
before printing any result otherwise. Imports nothing of JAX. Phases, each
raising on failure:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: compile the CUDA kernels from vm_asr_tpu_torch/csrc with nvcc and
   print what ptxas made of each kernel (registers, shared memory, spills).
3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the flagship 48 kHz forward (batch 1, and batch 8, the
   largest segment bucket) and train step (batch 4) give it, and at shapes
   off the main path: the fused forward (y, and its chunk states H0 against
   their plain version) and backward, the recurrence forward and reverse,
   with CUDA-event times beside the memory bound and device time by pass,
   under the exact kernel names each wrapper module exports. Every kernel
   runs twice on the same inputs and must give bitwise-equal outputs; the
   three one-launch scans (fused forward, recurrence forward and reverse)
   also run on a grid capped to a few CTAs, so that their tiles arrive in
   another order, and must give the same bits again. One recurrence call
   must be one kernel on the device. The backward is also timed with a
   cold L2.
3b. look-back window: the three one-launch scans' device time per train
   step and per batch-1 forward with the look-back's checkpoint spacing W
   at 8, 16, 32 and 64 (each wrapper's own W is the one it ships).
4. model: one flagship segment in fp32 through the generator with the
   kernels, and again with the scan routed to the plain versions.
5. train gradient: the fp32 flagship generator loss (STFT + MPD, batch 1)
   differentiated with the kernels, with the plain scan, and with the plain
   scan in fp64 as the witness both fp32 routes are held to.
6. serve: Inferencer.infer_file on three synthetic 16 kHz clips (tag
   16000_48000) with the full flagship generator (dims 16, depths 2-2-2-2,
   n_fft 1024, bf16 compute, seeded random weights), with launch counts.
7. profile: one batch-1 forward under torch.profiler.
8. train: the flagship GAN train step (batch 4, bf16, MPD, AdamW), 3
   warm-up and 10 timed steps on synthetic speech, with launch counts, then
   one profiled step by kernel (each wrapper's kernels by their exported
   names) and one by op and input shapes.
9. the kernels line, the card line, and the result line.

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
from vm_asr_tpu_torch.dsp import num_segments, resample_audio, save_wav
from vm_asr_tpu_torch.models import SS2D, get_discriminators, get_generator, set_scan_impl
from vm_asr_tpu_torch.models.ss2d import dt_bias_init_
from vm_asr_tpu_torch.ops import (
    fused_chunk_states_plain,
    linear_recurrence,
    linear_recurrence_plain,
    linear_recurrence_reverse,
    linear_recurrence_reverse_plain,
    selective_scan_fused,
    selective_scan_fused_bwd,
    selective_scan_fused_bwd_plain,
    selective_scan_fused_fwd,
    selective_scan_fused_plain,
)
from vm_asr_tpu_torch.ops.build import SOURCES, build, ptxas_info
from vm_asr_tpu_torch.ops.linear_recurrence import (
    LR_KERNELS,
    LR_REVERSE_KERNELS,
    linear_recurrence_fwd,
    lr_tile_layout,
)
from vm_asr_tpu_torch.ops.selective_scan_fused import BWD_KERNELS, FWD_KERNELS, fwd_tile_layout
from vm_asr_tpu_torch.train import (
    DiscState,
    GenState,
    Inferencer,
    make_optimizer,
    make_train_step,
    segment_bucket_counts,
)

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"
CONFIG = ROOT / "configs" / "vm_asr_48k_MPD.yaml"

# H100 SXM data sheet: HBM3 at 3.35 TB/s; 67 TFLOP/s fp32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per element: fused scan ~15 (softplus 6, exp, 2 muls for
# dt·A and dt·u·B, the recurrence's fma, y = C·h + D·u 3, decay product 1);
# its backward ~30 (the forward's 11 to rebuild h, the adjoint fma, da, du 3,
# ddts 5 with sigmoid 3, dB/dC terms 3, dA/dbias/dD sums 3, a·g 1); linear
# recurrence 2 (one fma), in reverse 3 (add, da, a·dh).
FUSED_OPS, FUSED_BWD_OPS, LR_OPS, LR_REV_OPS = 15, 30, 2, 3

# Scan calls of one flagship forward (two streams; 512×512 image, embed to
# 128² × 16 channels, stages at 128², 64², 32², 16² with d_inner 32..256 so
# K·D = 128..1024; out_vss2 and out_vss3 run at 256² and 512² with K·D 64
# and 8). (L, K·D) → calls. Phase 4 checks these against the model's SS2Ds.
FUSED_CALLS = {(16384, 128): 6, (4096, 256): 8, (1024, 512): 8, (256, 1024): 8}
LR_CALLS = {(65536, 64): 2, (262144, 8): 2}
K = 4
TRAIN_BATCH = 4  # DATA.BATCH_SIZE of the flagship config

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
# Backward kernels vs plain backward, elementwise. fp32: the JAX package's bar
# for the scan gradients (tests/test_fused_scan.py:50-51); the adjoint scans
# associate differently (the recurrence's reverse dh sums up to ~1/(1 - a) ≈
# 1000 terms, so its rounding exceeds the forward's 1e-4 bar), dB/dC sum the
# D lanes of a direction in another order than the plain version, and
# dA/dbias/dD are sums over B·L (up to 65 536 terms) taken in another order.
# bf16 du, ddts, dB, dC: both round one fp32 result to bf16, one ulp ≤ 2^-7
# of the value apart; dA/dbias/dD stay fp32.
BWD_FP32_TOL = dict(rtol=1e-3, atol=1e-3)
BWD_BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
# Generator gradient, fp32 (TF32 off), per tensor, against a witness that
# runs the plain scan in fp64 (the rest of the model fp32), for the kernels
# and for the plain fp32 scan alike: max |diff| <= GRAD_REL · max |fp64| +
# GRAD_FLOOR · (largest |fp64| over all tensors). Where a parameter's
# gradient sums 16 384 positions that cancel (the first stages' LayerNorm
# and MLP weights), fp32 rounding in the scans moves it by up to 2.3e-3 of
# its scale for the plain fp32 scan and 7.2e-4 for the kernels (measured on
# an H100, NVIDIA H100 80GB HBM3, 700 W): the kernels are the nearer of the
# two, so the kernels-vs-plain gap of ~2e-3 is the plain scan's rounding.
# GRAD_REL = 3e-3 holds the plain fp32 scan with 30 % room and the kernels
# with 4x; a kernel fault at a chunk boundary moves a gradient by O(1) of
# its scale. The floor, fp32's epsilon of the largest gradient, covers
# tensors whose gradient cancels to rounding noise (the narrow head's
# dt_projs and A_logs sit 1e-6..1e-14 below the largest). A scan that
# dropped a gradient leaves zeros: a 100 % difference, which fails this bar
# and the nonzero check on every SS2D parameter.
GRAD_REL, GRAD_FLOOR = 3e-3, 1.2e-7
# Cold-L2 timing: this many bytes written to a scratch buffer before each
# timed call (the H100's L2 holds 50 MB), then a spin of the device while the
# host enqueues the call, so that the call's events time its kernels alone.
FLUSH_BYTES = 256 << 20
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's 1.98 GHz
# Each wrapper's device kernels by pass, as its module exports them.
KERNEL_NAMES = {"selective_scan_fused": FWD_KERNELS, "selective_scan_fused_bwd": BWD_KERNELS,
                "linear_recurrence": LR_KERNELS, "linear_recurrence_reverse": LR_REVERSE_KERNELS}
# The one-launch scans again on a grid of this many CTAs (a C-side cap,
# the wrappers' max_ctas): their tiles then arrive in another order, and
# the result must not change by a bit.
CAPPED_CTAS = 5
# The look-back's checkpoint spacings timed in phase 3b.
WINDOWS = (8, 16, 32, 64)


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
    torch.profiler, as (name, start_us, end_us), after a warm-up call. The
    device-side spans of annotated regions (``Optimizer.step#AdamW.step``)
    are left out, as torch's own tables leave them out: they cover the gaps
    between their kernels."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def top_ops(fn, top: int = 8):
    """The aten ops of one call of ``fn`` (after a warm-up call) with the most
    device time of their own, grouped by input shapes, as (op, shapes, ms)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA],
                                record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, str(e.input_shapes), e.self_device_time_total / 1e3)
            for e in prof.key_averages(group_by_input_shape=True)
            if e.device_type == torch.autograd.DeviceType.CPU]
    return sorted(rows, key=lambda r: -r[2])[:top]


def busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def by_pass(events, kernels):
    """(calls, {pass: device ms per call}) of one wrapper, from the device
    events of some of its calls; raises on a kernel that no pass of the
    wrapper's exported names holds. calls is None when the passes were not
    captured the same number of times (the profiler dropped some events)."""
    per, seen = dict.fromkeys(kernels, 0.0), Counter()
    for name, s_, e_ in events:
        p = next((p for p, names in kernels.items() if name in names), None)
        if p is None:
            raise AssertionError(f"device kernel {name!r} is in no pass of {list(kernels)}")
        per[p] += (e_ - s_) / 1e3
        seen[p] += 1
    calls = seen[next(iter(kernels))]
    if calls == 0 or any(seen[p] != calls for p in kernels):
        return None, None
    return calls, {p: t / calls for p, t in per.items()}


def device_split(fn, kernels, n: int = 10, tries: int = 3):
    """(device ms of one call, kernels only, no launch gaps; {pass: ms}),
    over the calls that a capture of ``n`` calls holds whole; (None, None)
    if no capture in ``tries`` held them."""
    for _ in range(tries):
        events = device_kernels(fn, n)
        calls, passes = by_pass(events, kernels)
        if calls and calls > n:  # every pass, the forward's one kernel too, runs once per call
            raise AssertionError(f"{calls} launches of each pass in {n} calls")
        if calls:
            return busy_us(events) / calls / 1e3, passes
    return None, None


def by_wrapper(events):
    """Device ms and calls of each wrapper's kernels among ``events``, by the
    exact names each wrapper module exports (no kernel belongs to two
    wrappers); a call is counted at its wrapper's first pass (the one-launch
    scans' one kernel, the backward's fold)."""
    owner = {}
    for w, kernels in KERNEL_NAMES.items():
        for name in (n for names in kernels.values() for n in names):
            if owner.setdefault(name, w) != w:
                raise AssertionError(f"{name!r} is exported by {owner[name]} and {w}")
    ms, calls = Counter(), Counter()
    for name, s_, e_ in events:
        w = owner.get(name)
        if w is not None:
            ms[w] += (e_ - s_) / 1e3
            calls[w] += name in next(iter(KERNEL_NAMES[w].values()))
    return ms, calls


def cold_ms(fn, reps: int = 11) -> float:
    """Median ms of one call with a cold L2, by CUDA events around each call:
    FLUSH_BYTES written to a scratch buffer, then a device spin while the
    host enqueues the call."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    marks = []
    for i in range(reps):
        flush.fill_(float(i))
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s_.elapsed_time(e_) for s_, e_ in marks)


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def init_ranges(kd: int, gen: torch.Generator):
    """A, dt_bias and D_skip as the model initialises them (A_logs = log 1,
    dt ~ LogUniform(0.001, 0.1), D = 1), on the card."""
    bias = dt_bias_init_(torch.empty(kd), gen)
    return (-torch.ones(kd).cuda(), bias.cuda(), torch.ones(kd).cuda())


COUNTED = (selective_scan_fused, selective_scan_fused_bwd, linear_recurrence,
           linear_recurrence_reverse)


def zero_counts():
    for fn in COUNTED:
        fn.launches = 0


def read_counts():
    return {fn.__name__: fn.launches for fn in COUNTED}


def check_close(name, got, ref, tol):
    ok = torch.allclose(got.float(), ref.float(), **tol)
    err = (got.float() - ref.float()).abs().max().item()
    if not ok:
        raise AssertionError(f"{name}: kernel vs plain max |diff| {err:.3e} outside {tol}")
    return err


def fused_inputs(batch, l, kd, dtype, gen):
    g = torch.Generator(device="cuda").manual_seed(batch * 1_000_003 + l * 1009 + kd)
    a, bias, dsk = init_ranges(kd, gen)
    u = torch.randn(batch, l, kd, device="cuda", generator=g).to(dtype)
    dts = (0.5 * torch.randn(batch, l, kd, device="cuda", generator=g)).to(dtype)
    bs = torch.randn(batch, l, K, device="cuda", generator=g).to(dtype)
    cs = torch.randn(batch, l, K, device="cuda", generator=g).to(dtype)
    dy = torch.randn(batch, l, kd, device="cuda", generator=g).to(dtype)
    return (u, dts, bs, cs, a, bias, dsk, K), dy


def check_same(name, *runs):
    """Every run's tensors equal the first run's, bit for bit."""
    for i, run in enumerate(runs[1:], 1):
        for j, (x, y) in enumerate(zip(runs[0], run)):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: output {j} of run {i} differs from run 0 "
                                     f"(max |diff| {(x.float() - y.float()).abs().max():.3e})")


def check_fused(batch, l, kd, dtype, gen):
    """The forward kernel's y against the plain forward, its H0 against the
    plain chunk states, and a second call and a call on a capped grid
    against the first, bit for bit (the look-back's states are one fixed
    expression of the tiles' aggregates, csrc/scan_common.cuh)."""
    args, _ = fused_inputs(batch, l, kd, dtype, gen)
    u = args[0]
    y, h0, chunk = selective_scan_fused_fwd(*args)
    y2, h0_2, _ = selective_scan_fused_fwd(*args)
    y3, h0_3, _ = selective_scan_fused_fwd(*args, max_ctas=CAPPED_CTAS)
    torch.cuda.synchronize()
    check_same(f"fused {(batch, l, kd)} {dtype}", (y, h0), (y2, h0_2), (y3, h0_3))
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    name = f"fused {(batch, l, kd)} {dtype}"
    err = check_close(name, y, selective_scan_fused_plain(*args), tol)
    # H0 is fp32 in both IO dtypes: both sides compute it in fp32 from the
    # same inputs, associating the recurrence differently.
    h0_err = check_close(f"{name} H0", h0, fused_chunk_states_plain(*args, chunk), FP32_TOL)
    size = u.element_size()
    # u, dts read and y written; B, C read; A, bias, D_skip read; H0 written.
    nbytes = (3 * batch * l * kd + 2 * batch * l * K) * size + 3 * kd * 4 + h0.numel() * 4
    bms, by = bound_ms(nbytes, FUSED_OPS * batch * l * kd)
    dev, passes = device_split(lambda: selective_scan_fused(*args), FWD_KERNELS)
    return dict(kernel="selective_scan_fused", shape=[batch, l, kd], dtype=str(dtype),
                chunk=chunk, max_abs_err=err, tol=tol, h0_max_abs_err=h0_err,
                window=fwd_tile_layout(kd, K, chunk, size).window, bytes=nbytes,
                ms=cuda_ms(lambda: selective_scan_fused(*args)), device_ms=dev, passes=passes,
                plain_ms=cuda_ms(lambda: selective_scan_fused_plain(*args), reps=3, per=3),
                bound_ms=bms, bound_by=by)


def check_fused_bwd(batch, l, kd, dtype, gen):
    """The backward kernel's seven outputs against the plain backward, on the
    forward kernel's H0 and chunk, and against a second call of the kernel,
    bit for bit: no sum depends on the order in which blocks run."""
    (u, dts, bs, cs, a, bias, dsk, k), dy = fused_inputs(batch, l, kd, dtype, gen)
    _, h0, chunk = selective_scan_fused_fwd(u, dts, bs, cs, a, bias, dsk, k)
    kernel = lambda: selective_scan_fused_bwd(u, dts, bs, cs, dy, a, bias, dsk, h0, chunk, k)  # noqa: E731
    plain = lambda: selective_scan_fused_bwd_plain(u, dts, bs, cs, dy, a, bias, dsk, k)  # noqa: E731
    got, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"fused bwd {(batch, l, kd)} {dtype}: two calls differ")
    err = 0.0
    for i, (name, g_, r_) in enumerate(zip(("du", "ddts", "dbs", "dcs", "dA", "dbias", "dD"),
                                           got, ref)):
        if g_.dtype != r_.dtype or g_.shape != r_.shape:
            raise AssertionError(f"fused bwd {name}: {g_.dtype} {tuple(g_.shape)} vs plain "
                                 f"{r_.dtype} {tuple(r_.shape)}")
        tol = BWD_BF16_TOL if (dtype == torch.bfloat16 and i < 4) else BWD_FP32_TOL
        err = max(err, check_close(f"fused bwd {name} {(batch, l, kd)} {dtype}", g_, r_, tol))
    size = u.element_size()
    n_chunks = h0.shape[1]
    # u, dts, dy read and du, ddts written; B, C read and dB, dC written; H0
    # read; A, bias, D_skip read and dA, dbias, dD written.
    nbytes = (5 * batch * l * kd + 4 * batch * l * K) * size + batch * n_chunks * kd * 4 \
        + 6 * kd * 4
    bms, by = bound_ms(nbytes, FUSED_BWD_OPS * batch * l * kd)
    tol = BWD_BF16_TOL if dtype == torch.bfloat16 else BWD_FP32_TOL
    dev, passes = device_split(kernel, BWD_KERNELS)
    return dict(kernel="selective_scan_fused_bwd", shape=[batch, l, kd], dtype=str(dtype),
                chunk=chunk, max_abs_err=err, tol=tol, bytes=nbytes,
                ms=cuda_ms(kernel), device_ms=dev, passes=passes, cold_ms=cold_ms(kernel),
                plain_ms=cuda_ms(plain, reps=3, per=3), bound_ms=bms, bound_by=by)


def lr_inputs(rows, l, d, gen, seed):
    """a = exp(-dt) and b = dt·x with dt as the model's softplus of its
    dt_bias range, the forward's h from the plain version, and a gradient."""
    g = torch.Generator(device="cuda").manual_seed(rows * seed + l * 1009 + d)
    _, bias, _ = init_ranges(d, gen)
    dt = torch.nn.functional.softplus(
        0.5 * torch.randn(rows, l, d, device="cuda", generator=g) + bias)
    a = torch.exp(-dt)
    b = dt * torch.randn(rows, l, d, device="cuda", generator=g)
    return a, b, linear_recurrence_plain(a, b), torch.randn(rows, l, d, device="cuda", generator=g)


def one_kernel(name, fn, kernels):
    """The device events of one call of ``fn`` are one kernel of ``kernels``."""
    events = device_kernels(fn)
    names = [e[0] for e in events]
    if len(names) != 1 or names[0] not in kernels["scan"]:
        raise AssertionError(f"{name}: one call ran {names} on the device, not one kernel")


def check_lr(rows, l, d, gen):
    """The forward kernel's h against the plain version, and a second call
    and a call on a capped grid against the first, bit for bit."""
    a, b, ref, _ = lr_inputs(rows, l, d, gen, 1_000_003)
    h = linear_recurrence(a, b)
    runs = [(h,), (linear_recurrence(a, b),), (linear_recurrence_fwd(a, b, max_ctas=CAPPED_CTAS),)]
    torch.cuda.synchronize()
    name = f"linear_recurrence {(rows, l, d)}"
    check_same(name, *runs)
    err = check_close(name, h, ref, FP32_TOL)
    one_kernel(name, lambda: linear_recurrence(a, b), LR_KERNELS)
    nbytes = 3 * rows * l * d * 4
    bms, by = bound_ms(nbytes, LR_OPS * rows * l * d)
    dev, passes = device_split(lambda: linear_recurrence(a, b), LR_KERNELS)
    return dict(kernel="linear_recurrence", shape=[rows, l, d], dtype="torch.float32",
                max_abs_err=err, tol=FP32_TOL, window=lr_tile_layout(rows, l, d).window,
                bytes=nbytes, ms=cuda_ms(lambda: linear_recurrence(a, b)), device_ms=dev,
                passes=passes,
                plain_ms=cuda_ms(lambda: linear_recurrence_plain(a, b), reps=3, per=3),
                bound_ms=bms, bound_by=by)


def check_lr_reverse(rows, l, d, gen):
    """The reverse kernel's (da, db) against the plain version, and a second
    call and a call on a capped grid against the first, bit for bit."""
    a, _, h, grad = lr_inputs(rows, l, d, gen, 1_000_033)
    kernel = lambda: linear_recurrence_reverse(a, h, grad)  # noqa: E731
    got = kernel()
    runs = [got, kernel(), linear_recurrence_reverse(a, h, grad, max_ctas=CAPPED_CTAS)]
    ref = linear_recurrence_reverse_plain(a, h, grad)
    torch.cuda.synchronize()
    name = f"linear_recurrence reverse {(rows, l, d)}"
    check_same(name, *runs)
    err = max(check_close(f"{name} {n}", x, y, BWD_FP32_TOL)
              for n, x, y in zip(("da", "db"), got, ref))
    one_kernel(name, kernel, LR_REVERSE_KERNELS)
    nbytes = 5 * rows * l * d * 4
    bms, by = bound_ms(nbytes, LR_REV_OPS * rows * l * d)
    dev, passes = device_split(kernel, LR_REVERSE_KERNELS)
    return dict(kernel="linear_recurrence_reverse", shape=[rows, l, d], dtype="torch.float32",
                max_abs_err=err, tol=BWD_FP32_TOL,
                window=lr_tile_layout(rows, l, d, True).window, bytes=nbytes,
                ms=cuda_ms(kernel), device_ms=dev, passes=passes,
                plain_ms=cuda_ms(lambda: linear_recurrence_reverse_plain(a, h, grad),
                                 reps=3, per=3),
                bound_ms=bms, bound_by=by)


def window_sweep(gen):
    """Device ms of the one-launch scans by the look-back's checkpoint
    spacing W: per call at each main-path shape (bf16 for the fused
    forward), and summed per train step (batch 4) and per batch-1 forward."""
    out = {}
    for batch in (TRAIN_BATCH, 1):
        calls = []
        for (l, kd), n in FUSED_CALLS.items():
            args, _ = fused_inputs(batch, l, kd, torch.bfloat16, gen)
            calls.append(("selective_scan_fused", (batch, l, kd), n, FWD_KERNELS,
                          lambda w, args=args: selective_scan_fused_fwd(*args, window=w)))
        for (l, d), n in LR_CALLS.items():
            a, b, h, grad = lr_inputs(batch, l, d, gen, 1_000_003)
            calls.append(("linear_recurrence", (batch, l, d), n, LR_KERNELS,
                          lambda w, a=a, b=b: linear_recurrence_fwd(a, b, window=w)))
            if batch == TRAIN_BATCH:
                calls.append(("linear_recurrence_reverse", (batch, l, d), n, LR_REVERSE_KERNELS,
                              lambda w, a=a, h=h, g=grad: linear_recurrence_reverse(
                                  a, h, g, window=w)))
        for w in WINDOWS:
            for name, shape, n, kernels, fn in calls:
                dev, _ = device_split(lambda: fn(w), kernels)
                out[f"{name} {shape} W {w}"] = dev
                key = f"{name} batch {batch} W {w}"
                out[key] = None if out.get(key, 0.0) is None or dev is None \
                    else out.get(key, 0.0) + n * dev
    return out


def flagship_config(amp: bool, gan: bool = False):
    opts = ["TRAIN.ADVERSARIAL.ENABLE", str(gan), "AMP_ENABLE", str(amp),
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
        c.DATA.BATCH_SIZE = 4
        c.TRAIN.LOW_FREQ_REPLACEMENT = True
        c.TRAIN.ADVERSARIAL.DISCRIMINATORS = ["mpd"]
        c.merge_from_list(opts)
        update_config(c, argparse.Namespace())
    print(f"config: {CONFIG.name} {'via PyYAML' if have_yaml else 'as defaults + overrides'}")
    v, adv = c.MODEL.VSSM, c.TRAIN.ADVERSARIAL
    want = (c.MODEL.NAME, v.DIMS, list(v.DEPTHS), v.SSM_D_STATE, c.DATA.TARGET_SR,
            c.DATA.STFT.N_FFT, c.DATA.STFT.HOP_LENGTH, c.DTYPE.COMPUTE, c.DATA.BATCH_SIZE,
            v.DROP_PATH_RATE, list(adv.DISCRIMINATORS), list(adv.MPD_PERIODS), adv.MPD_HIDDEN,
            adv.FEATURE_LOSS_LAMBDA, adv.GAN_LOSS_TYPE, list(c.TRAIN.LOSSES.GEN),
            c.TRAIN.OPTIMIZER.NAME, c.TRAIN.LR_SCHEDULER.NAME)
    assert want == ("DualStreamInteractiveMambaUNet", 16, [2, 2, 2, 2], 1, 48000,
                    1024, 240, "bfloat16", TRAIN_BATCH, 0.1, ["mpd"], [2, 3, 5, 7, 11], 32,
                    100, "lsgan", ["multi_resolution_stft"], "adamw", "cosine"), want
    return c


def train_batch(cfg, seeds, device="cuda"):
    """A batch of flagship segments: the target is synthetic 48 kHz speech,
    the input the same resampled to 16 kHz and back (the band above 8 kHz
    gone), and highcut the bin of 8 kHz, as the 16 kHz → 48 kHz task has."""
    sr = cfg.DATA.TARGET_SR
    seg = int(cfg.DATA.SEGMENT * sr)
    y = np.stack([speech_like(seg / sr, sr, seed=s)[:seg] for s in seeds])
    x = resample_audio(resample_audio(y, sr, 16000), 16000, sr)[:, :seg]
    hf = int((1 + cfg.DATA.STFT.N_FFT // 2) * 16000 / sr)
    return {"wave_input": torch.from_numpy(np.ascontiguousarray(x[:, None])).to(device),
            "wave_target": torch.from_numpy(y[:, None]).to(device),
            "highcut": torch.full((len(seeds),), hf, dtype=torch.int64, device=device)}


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
    report["ptxas"] = {src: ptxas_info(src) for src in SOURCES}
    for src, lines in report["ptxas"].items():
        print(f"ptxas, {src}:")
        for line in lines:
            print(f"  {line}")

    t0 = phase("kernels vs plain, every main-path shape")
    gen = torch.Generator().manual_seed(0)
    checks = []
    for batch in (1, TRAIN_BATCH, 8):
        for (l, kd) in FUSED_CALLS:
            for dtype in (torch.bfloat16, torch.float32):
                checks.append(check_fused(batch, l, kd, dtype, gen))
    # The forward off the main path: L no multiple of the chunk, D = 48 (the
    # dims-24 config's first stage) and D = 33 (K·D = 132, no multiple of 32:
    # the kernel's instance for any group, staging by plain loads, and at
    # this L chunks of 64 steps that a thread walks in four sub-tiles,
    # staged again for the re-walk).
    for shape in ((2, 1000, 128), (4, 16384, 192), (4, 16384, 132)):
        for dtype in (torch.bfloat16, torch.float32):
            checks.append(check_fused(*shape, dtype, gen))
    for (l, kd) in FUSED_CALLS:
        for dtype in (torch.bfloat16, torch.float32):
            checks.append(check_fused_bwd(TRAIN_BATCH, l, kd, dtype, gen))
    # Off the main path, for the chunk boundaries: L no multiple of the chunk
    # (16, 32) over many chunks, and chunks of 2 and 4 sub-tiles (32, 64).
    for shape in ((2, 1000, 128), (1, 5000, 1024), (8, 16384, 128)):
        checks.append(check_fused_bwd(*shape, torch.float32, gen))
    # D = 48, no multiple of a warp: the first stage of the dims-24 config
    # (configs/vm_asr_48k_16k_MPD_VSSM24.yaml) at batch 4, and a ragged L.
    for dtype in (torch.bfloat16, torch.float32):
        checks.append(check_fused_bwd(TRAIN_BATCH, 16384, 192, dtype, gen))
    checks.append(check_fused_bwd(2, 1000, 192, torch.float32, gen))
    # D = 33, odd: a channel group's rows are no whole 16-byte pieces, so the
    # backward's pass 3 stages and stores by plain loads, and its bf16 fold
    # takes one channel per thread.
    for dtype in (torch.bfloat16, torch.float32):
        checks.append(check_fused_bwd(2, 1000, 132, dtype, gen))
    for rows in (1, TRAIN_BATCH, 8):
        for (l, d) in LR_CALLS:
            checks.append(check_lr(rows, l, d, gen))
    for rows in (1, TRAIN_BATCH):
        for (l, d) in LR_CALLS:
            checks.append(check_lr_reverse(rows, l, d, gen))
    # The recurrence off the main path: L no multiple of the tile (512 steps
    # at D = 8, 128 at D = 64) over many tiles; D = 1, 5 and 33 (groups of
    # that width, staged by plain loads, in the instance for any group).
    for shape in ((3, 100_003, 8), (2, 70_001, 64), (2, 50_000, 1), (2, 30_001, 5),
                  (2, 20_001, 33)):
        checks.append(check_lr(*shape, gen))
        checks.append(check_lr_reverse(*shape, gen))
    for c in checks:
        passes = "not measured" if c["passes"] is None else \
            ", ".join(f"{p} {t:.4f}" for p, t in c["passes"].items())
        extra = "; bitwise repeatable"
        if "cold_ms" in c:
            extra = f"; cold L2 {c['cold_ms']:.4f} ms{extra}"
        if "window" in c:
            extra = f"; W {c['window']}{extra}, also on {CAPPED_CTAS} CTAs"
        if "h0_max_abs_err" in c:
            extra = f"; H0 max|err| {c['h0_max_abs_err']:.3e} (tol {FP32_TOL}){extra}"
        print(f"{c['kernel']} {tuple(c['shape'])} {c['dtype'][6:]}: max|err| "
              f"{c['max_abs_err']:.3e} (tol {c['tol']}) kernel {c['ms']:.4f} ms "
              f"(device {fmt_ms(c['device_ms'])}: {passes}){extra}, plain "
              f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']}, "
              f"{c['bytes'] / 1e6:.2f} MB)")
    report["kernel_checks"] = checks
    print(f"kernels checked in {time.perf_counter() - t0:.1f} s")

    t0 = phase("look-back window: device ms per train step (batch 4) and per batch-1 forward")
    sweep = window_sweep(gen)
    for key, ms in sweep.items():
        print(f"{key}: {fmt_ms(ms)}")
    report["window_sweep"] = sweep
    print(f"swept in {time.perf_counter() - t0:.1f} s")

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

    t0 = phase("train gradient: fp32 flagship generator loss, kernels and plain scan vs "
               "the plain scan in fp64")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = flagship_config(amp=False, gan=True).defrost()
    # DropPath off: at batch 1 a dropped block legitimately has zero gradient,
    # which would hide a scan that drops it.
    cfg32.MODEL.VSSM.DROP_PATH_RATE = 0.0
    cfg32.freeze()
    model = get_generator(cfg32, "cuda")
    step = make_train_step(cfg32, model, get_discriminators(cfg32, "cuda"))
    batch = train_batch(cfg32, seeds=(20,))
    named = list(model.named_parameters())
    grads, totals, counts = {}, {}, {}
    for impl in ("kernel", "plain", "kernel again", "plain64"):
        set_scan_impl(model, impl.split()[0])
        zero_counts()
        total, _, _ = step.gen_loss_fn(batch["wave_input"], batch["wave_target"],
                                       batch["highcut"], torch.Generator(device="cuda"))
        grads[impl] = torch.autograd.grad(total, [p for _, p in named], allow_unused=True,
                                          materialize_grads=True)
        totals[impl] = total.item()
        counts[impl] = read_counts()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    witness = grads["plain64"]
    top = max(g.abs().max().item() for g in witness)

    def ratios(a, b):
        """Per tensor: max|a - b| / bar, max|a - b| / max|b|."""
        return [(((x - y).abs().max() / (GRAD_REL * y.abs().max() + GRAD_FLOOR * top)).item(),
                 ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item())
                for x, y in zip(a, b)]

    def worst_ratio(a, b):
        r = ratios(a, b)
        i = int(np.argmax([x for x, _ in r]))
        return r[i][0], named[i][0], b[i].abs().max().item()

    worst, worst_name, worst_scale = worst_ratio(grads["kernel"], witness)
    plain_worst, plain_name, _ = worst_ratio(grads["plain"], witness)
    apart, apart_name, _ = worst_ratio(grads["kernel"], grads["plain"])
    noise, noise_name, _ = worst_ratio(grads["kernel again"], grads["kernel"])
    kernel_r, plain_r = ratios(grads["kernel"], witness), ratios(grads["plain"], witness)
    order = sorted(range(len(named)), key=lambda i: -max(kernel_r[i][0], plain_r[i][0]))
    print("max|diff| / max|fp64| of the tensors furthest from the fp64 witness:")
    for i in order[:6]:
        print(f"  {named[i][0]}: kernels {kernel_r[i][1]:.3e}, plain fp32 {plain_r[i][1]:.3e} "
              f"(of the bar {kernel_r[i][0]:.3e}, {plain_r[i][0]:.3e})")
    zero = [name for (name, _), g in zip(named, grads["kernel"])
            if ".op." in name and not g.abs().max().item() > 0]
    want = dict(selective_scan_fused=30, selective_scan_fused_bwd=30, linear_recurrence=4,
                linear_recurrence_reverse=4)
    print(f"loss {totals['kernel']:.6f} (plain scan {totals['plain']:.6f}, fp64 "
          f"{totals['plain64']:.6f}); {len(named)} tensors; bar {GRAD_REL} of each tensor's "
          f"scale + {GRAD_FLOOR} of the largest ({top:.3e}); worst of the bar from the fp64 "
          f"witness: kernels {worst:.3e} ({worst_name}, scale {worst_scale:.3e}), plain fp32 "
          f"{plain_worst:.3e} ({plain_name}); kernels vs plain fp32 {apart:.3e} ({apart_name}); "
          f"the kernels run twice {noise:.3e} ({noise_name}); zero SS2D gradients {zero}; "
          f"kernel launches {counts['kernel']}; TF32 off")
    if worst > 1 or plain_worst > 1 or zero or counts["kernel"] != want \
            or any(counts["plain"].values()) or any(counts["plain64"].values()):
        raise AssertionError("train gradient check failed")
    report["train_grad_check"] = dict(
        worst_ratio=worst, worst_tensor=worst_name, worst_scale=worst_scale,
        plain_worst_ratio=plain_worst, plain_worst_tensor=plain_name,
        kernel_vs_plain_ratio=apart, rerun_ratio=noise, rel=GRAD_REL, floor=GRAD_FLOOR,
        top=top, furthest=[(named[i][0], kernel_r[i][1], plain_r[i][1]) for i in order[:6]],
        loss_kernel=totals["kernel"], loss_plain=totals["plain"],
        loss_fp64=totals["plain64"], launches=counts["kernel"])
    del model, step, grads
    print(f"gradients checked in {time.perf_counter() - t0:.1f} s")

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
    zero_counts()
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
    serve_launches = read_counts()
    print(f"serve: {len(requests)} requests, {forwards} forwards, launches {serve_launches}")
    if serve_launches["selective_scan_fused_bwd"] or serve_launches["linear_recurrence_reverse"]:
        raise AssertionError("serving ran a backward kernel")
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
    scan_ms = sum(by_wrapper(events)[0].values())
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

    t0 = phase("train: flagship GAN train step, batch 4, bf16")
    cfg = flagship_config(amp=True, gan=True)
    model = get_generator(cfg, "cuda")
    discs = get_discriminators(cfg, "cuda")
    steps_per_epoch = 1000
    gen_state = GenState(model, make_optimizer(cfg, steps_per_epoch, model))
    disc_states = {n: DiscState(d, make_optimizer(cfg, steps_per_epoch, d))
                   for n, d in discs.items()}
    step = make_train_step(cfg, model, discs)
    batches = [train_batch(cfg, seeds=range(30 + TRAIN_BATCH * i, 30 + TRAIN_BATCH * (i + 1)))
               for i in range(4)]
    rng = torch.Generator(device="cuda").manual_seed(cfg.SEED)
    before = {n: t.detach().clone() for n, t in
              list(model.named_parameters()) + list(discs["mpd"].named_parameters())}
    run = lambda i: step(gen_state, disc_states, batches[i % len(batches)], rng)  # noqa: E731
    # The first step's generator gradient, from the same batch, weights and
    # DropPath draws as the step itself, for the check of unchanged tensors.
    rng_state = rng.get_state()
    b0 = batches[0]
    total, _, _ = step.gen_loss_fn(b0["wave_input"], b0["wave_target"], b0["highcut"], rng)
    first_grad = {n: g.abs().max().item() for (n, _), g in zip(
        model.named_parameters(), torch.autograd.grad(total, gen_state.params,
                                                      allow_unused=True, materialize_grads=True))}
    rng.set_state(rng_state)
    del total
    for i in range(3):  # warm-up: cuDNN autotuning, allocator
        run(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_steps = 10
    zero_counts()
    marks, history = [], []
    for i in range(n_steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        history.append(run(3 + i)[2])
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    train_launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [s_.elapsed_time(e_) for s_, e_ in marks]
    median_ms = statistics.median(step_ms)
    values = [{k: float(v) for k, v in m.items()} for m in history]
    finite = all(np.isfinite(v) for m in values for v in m.values())
    changed = [n for n, t in list(model.named_parameters()) +
               list(discs["mpd"].named_parameters()) if not torch.equal(before[n], t)]
    per_step = {k: v / n_steps for k, v in train_launches.items()}
    want = dict(selective_scan_fused=30, selective_scan_fused_bwd=30, linear_recurrence=4,
                linear_recurrence_reverse=4)
    print(f"{n_steps} steps: median {median_ms:.2f} ms/step (CUDA events; min "
          f"{min(step_ms):.2f}, max {max(step_ms):.2f}), "
          f"{TRAIN_BATCH * cfg.DATA.SEGMENT / (median_ms / 1e3):.2f}x real time, peak "
          f"memory {peak_gb:.2f} GB; launches per step {per_step}")
    print(f"first step {json.dumps(values[0])}")
    print(f"last step {json.dumps(values[-1])}")
    # A tensor may stay unchanged only if its gradient is below AdamW's eps:
    # the update lr·m/(sqrt(v) + eps) is then far below lr and rounds away.
    # Any gradient above eps moves it by about lr (≥ MIN_LR = 1e-5 here) on
    # the first step, more than half an ulp of any |parameter| < 8.
    eps = cfg.TRAIN.OPTIMIZER.EPS
    unchanged = {n: first_grad.get(n) for n in sorted(set(before) - set(changed))}
    stuck = [n for n, g in unchanged.items() if g is None or not g < eps]
    print(f"finite {finite}; parameters changed {len(changed)} of {len(before)} tensors; "
          f"unchanged, with the first step's max|grad| (AdamW eps {eps}): {unchanged}")
    if not finite or per_step != want or stuck:
        raise AssertionError(f"train phase failed; unchanged with a gradient: {stuck}")
    for _ in range(3):  # a capture that dropped events counts the scan calls short
        events = device_kernels(lambda: run(0))
        in_step, in_step_calls = by_wrapper(events)
        if dict(in_step_calls) == want:
            break
    busy = busy_us(events) / 1e3
    by_name = Counter()
    for name, s_, e_ in events:
        by_name[name] += (e_ - s_) / 1e3
    scan_ms = sum(in_step.values())
    idle = (1 - busy / median_ms) if events else None
    print(f"one profiled step: device busy {fmt_ms(busy if events else None)} in "
          f"{len(events)} device events, scan kernels {scan_ms:.3f} ms, idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'} (of the median step)")
    print(f"scan kernels in the step, by wrapper (exported kernel names): "
          f"{ {w: round(t, 4) for w, t in in_step.items()} } ms, calls {dict(in_step_calls)}")
    if events and dict(in_step_calls) != want:
        raise AssertionError(f"profiled step: scan calls by kernel name {dict(in_step_calls)} "
                             f"!= {want}")
    for n, t in by_name.most_common(12):
        print(f"  {t:8.3f} ms  {n[:100]}")
    ops = top_ops(lambda: run(1))
    print("ops with the most device time of their own in one step, by input shapes:")
    for op, shapes, t in ops:
        print(f"  {t:8.3f} ms  {op} {shapes[:150]}")
    report["train"] = dict(batch=TRAIN_BATCH, dtype="bfloat16", steps=n_steps, step_ms=step_ms,
                           median_ms=median_ms, x_real_time=TRAIN_BATCH * cfg.DATA.SEGMENT
                           / (median_ms / 1e3), peak_memory_gb=peak_gb,
                           launches=train_launches, metrics=values,
                           unchanged_first_grad=unchanged,
                           device_busy_ms=busy if events else None, idle_share=idle,
                           device_events=len(events), scan_kernels_ms=scan_ms,
                           scan_kernels_by_wrapper=in_step, top=by_name.most_common(20),
                           top_ops=ops)
    print(f"trained in {time.perf_counter() - t0:.1f} s")

    def per_train_step(name, calls, dtype, batch=TRAIN_BATCH):
        """Sums over one train step's calls (batch 4), or one served
        forward's (batch 1), of the per-shape rows."""
        rows = {tuple(c["shape"][1:]): c for c in checks if c["kernel"] == name
                and c["shape"][0] == batch and c["dtype"] == dtype}
        out = {key: sum(n * rows[s][key] for s, n in calls.items())
               for key in ("ms", "plain_ms", "bound_ms")}
        dev = [rows[s]["device_ms"] for s in calls]
        out["device_ms"] = None if None in dev else sum(n * rows[s]["device_ms"]
                                                       for s, n in calls.items())
        out["max_abs_err"] = max(c["max_abs_err"] for c in checks if c["kernel"] == name)
        return out

    def entry(name, src, replaces, parts, **extra):
        sums = [per_train_step(*part) for part in parts]
        dev = [x["device_ms"] for x in sums]
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=train_launches[name],
                    max_abs_err=max(x["max_abs_err"] for x in sums),
                    ms=sum(x["ms"] for x in sums), plain_ms=sum(x["plain_ms"] for x in sums),
                    device_ms=None if None in dev else sum(dev),
                    in_step_device_ms=sum(in_step[part[0]] for part in parts) if events else None,
                    bound_ms=sum(x["bound_ms"] for x in sums), bound_by="bytes",
                    library_ms=None, check="pass",
                    per="one batch-4 train step, summed over its calls", **extra)

    bwd_step = per_train_step("selective_scan_fused_bwd", FUSED_CALLS, "torch.bfloat16")
    bwd_rows = [c for c in checks if c["kernel"] == "selective_scan_fused_bwd"
                and c["shape"][0] == TRAIN_BATCH and c["dtype"] == "torch.bfloat16"
                and tuple(c["shape"][1:]) in FUSED_CALLS]
    bwd_cold = sum(FUSED_CALLS[tuple(c["shape"][1:])] * c["cold_ms"] for c in bwd_rows)
    print(f"fused backward per train step: in the profiled step "
          f"{fmt_ms(in_step['selective_scan_fused_bwd'] if events else None)} device; "
          f"back to back {fmt_ms(bwd_step['device_ms'])} device, {bwd_step['ms']:.4f} ms "
          f"wrapper; cold L2 {bwd_cold:.4f} ms; bound {bwd_step['bound_ms']:.4f} ms")

    def per_step_line(title, name, calls, dtype, serve):
        """Print one one-launch scan's device, wrapper and bound figures per
        train step and (serve) per batch-1 forward; returns both sums."""
        step = per_train_step(name, calls, dtype)
        fwd = per_train_step(name, calls, dtype, batch=1) if serve else None
        line = (f"{title} per train step: in the profiled step "
                f"{fmt_ms(in_step[name] if events else None)} device; back to back "
                f"{fmt_ms(step['device_ms'])} device, {step['ms']:.4f} ms wrapper; bound "
                f"{step['bound_ms']:.4f} ms")
        if fwd is not None:
            line += (f". Per batch-1 forward: {fmt_ms(fwd['device_ms'])} device, "
                     f"{fwd['ms']:.4f} ms wrapper, bound {fwd['bound_ms']:.4f} ms")
        print(line)
        return step, fwd

    _, fwd_serve = per_step_line("fused forward", "selective_scan_fused", FUSED_CALLS,
                                 "torch.bfloat16", serve=True)
    _, lr_serve = per_step_line("recurrence forward", "linear_recurrence", LR_CALLS,
                                "torch.float32", serve=True)
    per_step_line("recurrence reverse", "linear_recurrence_reverse", LR_CALLS, "torch.float32",
                  serve=False)
    repeat = ("bitwise equal on two calls and on a grid of "
              f"{CAPPED_CTAS} CTAs at every shape checked")

    kernels = [
        entry("selective_scan_fused", "vm_asr_tpu_torch/csrc/fused_scan.cu",
              "vm_asr_tpu/ops/selective_scan_fused.py:141",
              [("selective_scan_fused", FUSED_CALLS, "torch.bfloat16")],
              serve_launches=serve_launches["selective_scan_fused"],
              serve_forward_device_ms=fwd_serve["device_ms"],
              serve_forward_bound_ms=fwd_serve["bound_ms"], repeatable=repeat),
        entry("selective_scan_fused_bwd", "vm_asr_tpu_torch/csrc/fused_scan_bwd.cu",
              "vm_asr_tpu/ops/selective_scan_fused.py:367",
              [("selective_scan_fused_bwd", FUSED_CALLS, "torch.bfloat16")], cold_ms=bwd_cold,
              repeatable="bitwise equal on two calls at every shape checked"),
        entry("linear_recurrence", "vm_asr_tpu_torch/csrc/linear_recurrence.cu",
              "vm_asr_tpu/ops/linear_recurrence.py:172",
              [("linear_recurrence", LR_CALLS, "torch.float32")],
              serve_launches=serve_launches["linear_recurrence"],
              serve_forward_device_ms=lr_serve["device_ms"],
              serve_forward_bound_ms=lr_serve["bound_ms"], repeatable=repeat),
        entry("linear_recurrence_reverse", "vm_asr_tpu_torch/csrc/linear_recurrence.cu",
              "vm_asr_tpu/ops/linear_recurrence.py:241",
              [("linear_recurrence_reverse", LR_CALLS, "torch.float32")], repeatable=repeat),
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
