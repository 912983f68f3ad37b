#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, and this repository around it; exits non-zero
before printing any result otherwise. Imports nothing of JAX. Phases, each
raising on failure:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: compile the CUDA kernels from vm_asr_tpu_torch/csrc with nvcc and
   print what ptxas made of each kernel (registers, shared memory, spills);
   compile the host C++ library (native/src, g++) and print its seconds.
3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the flagship 48 kHz forward (batch 1, and batch 8, the
   largest segment bucket) and train step (batch 4) give it, and at shapes
   off the main path: the fused forward (y, and its chunk states H0 against
   their plain version) and backward, the recurrence forward and reverse,
   and at the VMamba classifier's recurrence shapes (phase 14: L = 3136..49,
   no multiple of the tile, D = 768..6144),
   with CUDA-event times beside the memory bound and device time by pass,
   under the exact kernel names each wrapper module exports. Every kernel
   runs twice on the same inputs and must give bitwise-equal outputs; the
   three one-launch scans (fused forward, recurrence forward and reverse)
   also run on a grid capped to a few CTAs, so that their tiles arrive in
   another order, and must give the same bits again. One recurrence call
   must be one kernel on the device, launched once and right. The backward
   is also timed with a cold L2. Then, in a process of its own, the
   LayerNorm kernel (csrc/layer_norm.cu) against its plain version (torch's
   route) at every shape of the LayerNorm censuses of a forward without a
   gradient (the flagship generator at dims 16 and 24, VMamba-T v0 from the
   classify cell's configuration), batch 1 and 8 (128 for the classifier),
   bf16 (one ulp) and fp32 (1e-5), with the share that differs, bitwise on
   two calls, with device ms beside the byte bound and torch's route's
   (library_ms), which in bf16 it must not exceed, and the sums over a
   forward's calls; then each census against the models' own calls at
   batch 1 and 2, with 114, 114 and 35 launches a forward, every LayerNorm
   on the device the kernel's under its exported names, none of torch's.
3b. look-back under contention: a kernel built here (HOLD_SOURCE) holds 128
   of the card's 132 SMs for 200 ms while the fused forward and the
   recurrence (both directions) run at a main-path shape on another
   stream; each must end before the hold does, on the 4 SMs left, with the
   bits of its uncontended run (the look-back's tile ticket,
   csrc/scan_common.cuh).
3c. look-back in CUDA graphs: each one-launch scan captured in a graph on a
   side stream at main-path shapes and replayed three times with fresh
   inputs copied in before each replay, each replay bitwise the eager call
   on the same inputs; and each across the look-back's epoch (kept on the
   device, csrc/scan_common.cuh): a call at the last epoch gives the bits
   of the call before it, also on a capped grid, and leaves the workspace
   zeroed, and the call after it (epoch 1) gives them again.
3d. look-back window: the three one-launch scans' device time per train
   step and per batch-1 forward with the look-back's checkpoint spacing W
   at 8, 16, 32 and 64 (each wrapper's own W is the one it ships).
4. model: one flagship segment in fp32 through the generator with the
   kernels, and again with the scan routed to the plain versions.
5. train gradient: the fp32 flagship generator loss (STFT + MPD, batch 1)
   differentiated with the kernels, with the plain scan, and with the plain
   scan in fp64 as the witness both fp32 routes are held to.
6. serve: Inferencer.infer_file on three synthetic 16 kHz clips (tag
   16000_48000) with the full flagship generator (dims 16, depths 2-2-2-2,
   n_fft 1024, bf16 compute, seeded random weights), with launch counts;
   then its forward (one CUDA graph per bucket, train/steps.py:
   GraphedForward) at buckets 1, 2, 4 and 8, three calls each (eager on
   first sight, the capture's replay, a replay) bitwise the generator's
   eager forward, and two bucket-8 replays read only after both ran; and
   dsp.istft bitwise torch.istft at the forward's spectra.
7. profile: one batch-1 forward (a replay) under torch.profiler, and its
   device kernels against an eager forward's: the same names apart from
   copies, busy times within 5 %; its 114 LayerNorms all the kernel's, none
   of torch's LayerNorm kernels.
8. train: the flagship GAN train step (batch 4, bf16, MPD, AdamW), 3
   warm-up and 10 timed steps on synthetic speech, with launch counts (no
   LayerNorm kernel: autograd records the step; every GAN step checked
   asserts it), then
   one profiled step by kernel (each wrapper's kernels by their exported
   names) and one by op and input shapes; then the dims-24 config's GAN step
   (configs/vm_asr_48k_16k_MPD_VSSM24.yaml, D = 48 at stage 0) at batch 4,
   3 warm-up and 5 timed steps, launches derived from its SS2Ds, finite
   losses, every parameter with a gradient changed, busy ms and peak memory.
8b. scan routes: host time a call of each scan wrapper as an autograd
   Function (the main path) and as a dispatcher op (checkpointed blocks),
   and the train step with every SS2D on each route.
9. cli: the port's own entry point, vm_asr_tpu_torch.cli, in-process at the
   flagship's full width and depth on the synthetic corpus (16 kHz input):
   train one epoch (5 steps at batch 4, one validation batch) with
   checkpoints, resume for a second epoch (one step profiled), --eval of
   the best checkpoint on four two-segment clips, and --throughput at
   batch 4, with exact launch counts for each; plus the time of one
   DegradingSampler.sample at input rates drawn as the flagship config
   draws them.
10. variants: the remaining generator variants at the flagship's width
   (dims 16, depths 2-2-2-2, n_fft 1024, hop 240): the SINGLE, P2M and M2P
   configs loaded from their YAML, then MambaUNet (VM_ASR_BASIC), the
   latent layout (dims 16..256), the v2 and v1 heads, patch-embed v1, GMLP,
   FUSE_STREAMS and SSM_D_STATE 2 (every SS2D on the general-N route), each
   one batch-1 segment in fp32 with the kernels
   against the plain scan, with launch counts derived from the model's
   SS2Ds and routing, and its bf16 forward timed; SINGLE through the CLI
   (train 4 steps with validation, checkpoints and one profiled step,
   --eval of the best checkpoint on two clips, --inference on one) with
   exact launch counts; the fp32 generator gradients of the latent layout
   (the fused backward at D = 512) and of FUSE_STREAMS (the mag decoder's
   scans at 2B rows) against the plain-fp64-scan witness; the FUSE_STREAMS
   GAN step (MPD, AdamW) at batch 8 in bf16, 3 warm-up and 5 timed steps,
   with launches derived from its SS2Ds, finite losses and every parameter
   with a gradient changed; the flagship generator at batch 32 (the fused
   kernels' 256-step chunks) as the variants' forwards are checked; and a SINGLE generator step
   with and without USE_CHECKPOINT (gradients, launches and peak memory).
11. stacked and adversarial options: the fused forward with two parameter
   sets (the stream-stacked generator's one launch for both streams)
   against its plain version at every stacked flagship shape (batch 1 and
   the batch-8 bucket), bitwise on two calls and on a capped grid, and the
   recurrence at the stacked rows; the stacked flagship generator
   (MODEL.VSSM.STACKED_EXECUTION) in fp32 against the unstacked one, with
   exactly 15 fused and 2 recurrence launches a forward and functorch's
   per-stream-loop warning made an error; its batch-1 forward profiled
   beside the unstacked one; the Inferencer on the three serve clips and
   --eval, --inference and --throughput through the CLI, stacked, with
   exact launch counts; then the flagship GAN step with the MSD, with the
   period-stacked MPD (one group, and [[2,3],[5,7,11]]) and with wgan-gp,
   beside the flagship MPD step: one fp32 step's losses against the MPD
   step's from the same weights (5e-4 relative), then 3 warm-up and 10
   timed bf16 steps with launch counts, peak memory and a profiled step
   (the MPD step's timed again first, beside the train phase's).
12. raw corpus: write a VCTK-0.92-shaped FLAC tree (p225, p226, p227 and p280, which the
   conversion skips; 12 utterances of 3 s each at 48 kHz, 16-bit) with the
   encoder of tests/flac_ref.py, decode every file bitwise back to its PCM,
   time DegradingSampler.sample with the C++ resampler against scipy at
   eight drawn input rates (within 1e-5) and the threads pipeline against
   the worker-process pipeline at batch 4 and 24; then the CLI trains the
   flagship at full width and depth from the FLAC tree (converted by
   get_loaders, DATA.PIPELINE grain, 4 workers, TRAIN_SPLIT [2,1], 5 steps,
   a validation batch, one step profiled, checkpoints) and runs --eval on
   the held-out speaker's converted clips, with exact launch counts.
13. parallel: two ranks on cuda:0 over gloo (NCCL takes one rank a card):
   the flagship fp32 GAN step at global batch 4 (2 rows a rank) against
   one process, losses and every gradient leaf within 5× a control (read
   against two: the one-process step on the rows permuted, and on the rows
   twice over, batch 8; PAR_CONTROL's gates); three chained dp2
   steps, a rank-0 checkpoint, a restore on both ranks and a resumed step
   against the same in one process; dp1 × mp2 (each rank scans 2 of the 4
   directions) against the unsplit forward and gradients; the
   sequence-sharded fused scan over the two ranks at (4, 16384, 128)
   against the one-device kernel; NCCL at world size 1 through the dp
   step's collectives; and the CLI's ranks (--opts MESH.DP 2) on the card;
   with the dp2 step's ms and the phase's seconds beside the card's line.
14. vssm: the VMamba classifier (models/vssm.py) at its defaults (dims 96,
   depths 2-2-9-2, d_state 16: without a gradient every SS2D takes the
   N-state kernel, with one the general-N route, one recurrence launch a
   state channel) on 224×224×3 images from a seeded
   init: its parameter count against the JAX package's; the fp32 logits at
   batch 8 with the kernels against the plain scan (and both against the
   plain scan in fp64), with exactly 15 N-state and no other launches;
   the bf16 forward at batch 8 timed (CUDA events) and profiled (busy time,
   idle share, the N-state kernel's device time by kernel name); the fp32
   gradient of the logits against a seeded cotangent at batch 2, kernels
   against plain, with 240 recurrence and 240 reverse launches and the peak
   memory; BackboneVSSM's feature shapes; and matmul_flops of the batch-1
   forward equal to the JAX package's count. A side check of the modules at
   the class defaults (MLP ratio 4, patch embed v2: 43.76 M parameters),
   not a published configuration: the published VMamba-T v0 runs through
   the configuration and ``train/classifier.py`` in the benchmark's
   ``vssm_tiny.classify`` cell.
15. checks: vm_asr_tpu_torch.checks with --grid (every kernel against its
   plain version at the JAX package's grid, and the micro-benchmarks).
16. trajectory: python -m vm_asr_tpu_torch.trajectory and ... --gan, two
   processes side by side, 12 epochs in fp32 against the JAX Trainer's
   curves in artifacts/trajectory_torch, with the chaos floor and the
   defect, on torch's deterministic algorithms; fails when an arm's gap
   exceeds its gate (its bar, or its largest chaos floor recorded on the
   card where that lies above the bar) or when an arm's defect breaks no
   gate.
17. nstate: the N-state scan (csrc/nstate_scan.cu, d_state 16) against its
   plain version at the VMamba classifier's four scan shapes at batch 8
   (bf16 and fp32; the states split over lanes) and batch 128 (bf16; one
   thread a chain), and at D = 33 (plain loads); one call one kernel under
   its exported name; bitwise equal on two calls and in a CUDA graph's
   replay; device time beside its byte bound and its exp bound, summed over
   a forward's 15 calls. In a process of its own (nstate_process).
18. the script's seconds, the kernels line, the card line, and the result line.

Per-shape numbers also go to chiprun_out/chip_smoke/report.json.
"""

from __future__ import annotations

import argparse
import csv
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from vm_asr_tpu_torch import checks as port_checks
from vm_asr_tpu_torch import cli
from vm_asr_tpu_torch.core import default_config, load_config, update_config
from vm_asr_tpu_torch.core.profiling import matmul_flops, model_flops
from vm_asr_tpu_torch.data import DataPipeline, DegradingSampler, SyntheticVCTK, native
from vm_asr_tpu_torch.dsp import num_segments, resample_audio, save_wav
from vm_asr_tpu_torch.dsp.stft import hann_window, istft
from vm_asr_tpu_torch.models import (
    SS2D,
    BackboneVSSM,
    DualStreamStackedMambaUNet,
    LayerNorm,
    build_classifier,
    get_discriminators,
    get_generator,
    get_vssm,
    set_scan_impl,
    to_stacked,
)
from vm_asr_tpu_torch.models.ss2d import dt_bias_init_
from vm_asr_tpu_torch.ops import (
    fused_chunk_states_plain,
    layer_norm,
    layer_norm_plain,
    linear_recurrence,
    linear_recurrence_plain,
    linear_recurrence_reverse,
    linear_recurrence_reverse_plain,
    selective_scan_fused,
    selective_scan_fused_bwd,
    selective_scan_fused_bwd_plain,
    selective_scan_fused_fwd,
    selective_scan_fused_plain,
    selective_scan_nstate,
    selective_scan_nstate_plain,
)
from vm_asr_tpu_torch.ops import lookback
from vm_asr_tpu_torch.ops.build import SOURCES, build, ptxas_info
from vm_asr_tpu_torch.ops.layer_norm import LAYER_NORM_KERNELS, layer_norm_plan
from vm_asr_tpu_torch.ops.linear_recurrence import (
    LR_KERNELS,
    LR_REVERSE_KERNELS,
    linear_recurrence_fwd,
    lr_tile_layout,
)
from vm_asr_tpu_torch.ops.selective_scan_fused import BWD_KERNELS, FWD_KERNELS, fwd_tile_layout
from vm_asr_tpu_torch.ops.selective_scan_nstate import (
    NSTATE_KERNELS,
    NSTATE_N,
    nstate_tile_layout,
)
from vm_asr_tpu_torch.train import tester as tester_module
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
# The host C++ resampler against scipy (the JAX package's bar, tests/test_native.py).
NATIVE_TOL = 1e-5
# USE_CHECKPOINT's bf16 step against the same step without it, in bars of
# the train-gradient check: bf16 runs with it against one without, and two
# without it, read 2.42-4.15 of the bar on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md).
BF16_CKPT_BARS = 10.0
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
# The N-state kernel against its plain version, elementwise. fp32: the
# FP32_TOL bar (y sums 16 states, each its recurrence associated otherwise
# and its decay from the SFU's exp2, 7e-7 of the output's scale apart on an
# H100). bf16: one fp32 result rounded once on each side, as BF16_TOL, but
# near 0 the two fp32 sums, ~1e-5 apart at the classifier's scale, round
# to bf16 values that far apart, above BF16_TOL's 1e-5.
NSTATE_FP32_TOL = FP32_TOL
NSTATE_BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
# The N-state kernel's exp bound: N exponentials an element (softplus's one
# aside) on the SFU, 16 results a clock on each of 132 SMs, at 1.755 GHz.
SFU_EXP_PER_S = 132 * 16 * 1.755e9
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
# The look-back's checkpoint spacings timed in phase 3d.
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


def device_scan_calls(fn, want, tries: int = 3):
    """Each wrapper's scan calls in one call of ``fn`` (after a warm-up
    call), counted from the device events by their exported names
    (by_wrapper): what ran on the card, a CUDA graph's replay included,
    where the wrappers' own counters see only the launches the host
    issued. A capture that counts other than ``want`` is taken again (the
    profiler may drop events), at most ``tries`` times; returns the last
    count."""
    for _ in range(tries):
        calls = by_wrapper(device_kernels(fn))[1]
        got = {w: calls[w] for w in KERNEL_NAMES}
        if got == want:
            break
    return got


def issued_forwards(forward) -> int:
    """The forwards whose kernels the host launched one by one through
    ``forward`` (train/steps.py: GraphedForward): the eager first call of
    each signature it saw and the capture of each it captured. A replay
    launches none of them from the host."""
    return len(forward.seen) + len(forward.graphs)


def forward_counts(forwards: int, fused: int = 30, lr: int = 4) -> dict:
    """The wrappers' launch counts of ``forwards`` generator forwards of
    ``fused`` fused and ``lr`` recurrence scans each."""
    return dict(selective_scan_fused=fused * forwards, selective_scan_fused_bwd=0,
                linear_recurrence=lr * forwards, linear_recurrence_reverse=0)


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
    for fn in COUNTED + (selective_scan_nstate, layer_norm):
        fn.launches = 0


def read_counts():
    return {fn.__name__: fn.launches for fn in COUNTED}


def vssm_counts():
    """read_counts with the N-state kernel's launches: the classifier's
    phases, the only ones that run it."""
    return dict(read_counts(), selective_scan_nstate=selective_scan_nstate.launches)


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


def one_kernel(name, fn, kernels, wrapper, check, tries: int = 3) -> int:
    """One call of ``fn`` runs one kernel of ``kernels``: under torch.profiler
    the call's device events are that one kernel, ``wrapper``'s launch count
    moves by one across it, and ``check`` holds its result to the plain
    version. A capture that holds no device event at all is taken again (at
    most ``tries`` captures), and only when its call did launch the kernel
    once and its result was right; returns the number of such captures."""
    fn()
    torch.cuda.synchronize()
    empty = 0
    for _ in range(tries):
        before = wrapper.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        launched = wrapper.launches - before
        check(out)
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
        if launched != 1 or (names and (len(names) != 1 or names[0] not in kernels["scan"])):
            raise AssertionError(f"{name}: one call launched {launched} kernels and ran "
                                 f"{names} on the device, not one kernel")
        if names:
            return empty
        empty += 1
    raise AssertionError(f"{name}: {tries} captures of one call held no device event")


def check_lr(rows, l, d, gen, one_call: bool = True):
    """The forward kernel's h against the plain version, and a second call
    and a call on a capped grid against the first, bit for bit; with
    ``one_call``, one call is one kernel on the device (one_kernel)."""
    a, b, ref, _ = lr_inputs(rows, l, d, gen, 1_000_003)
    h = linear_recurrence(a, b)
    runs = [(h,), (linear_recurrence(a, b),), (linear_recurrence_fwd(a, b, max_ctas=CAPPED_CTAS),)]
    torch.cuda.synchronize()
    name = f"linear_recurrence {(rows, l, d)}"
    check_same(name, *runs)
    err = check_close(name, h, ref, FP32_TOL)
    empty = one_kernel(name, lambda: linear_recurrence(a, b), LR_KERNELS, linear_recurrence,
                       lambda out: check_close(name, out, ref, FP32_TOL)) if one_call else None
    nbytes = 3 * rows * l * d * 4
    bms, by = bound_ms(nbytes, LR_OPS * rows * l * d)
    dev, passes = device_split(lambda: linear_recurrence(a, b), LR_KERNELS)
    return dict(kernel="linear_recurrence", shape=[rows, l, d], dtype="torch.float32",
                max_abs_err=err, tol=FP32_TOL, window=lr_tile_layout(rows, l, d).window,
                empty_captures=empty, bytes=nbytes, ms=cuda_ms(lambda: linear_recurrence(a, b)),
                device_ms=dev, passes=passes,
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
    empty = one_kernel(name, kernel, LR_REVERSE_KERNELS, linear_recurrence_reverse,
                       lambda out: [check_close(f"{name} {n}", x, y, BWD_FP32_TOL)
                                    for n, x, y in zip(("da", "db"), out, ref)])
    nbytes = 5 * rows * l * d * 4
    bms, by = bound_ms(nbytes, LR_REV_OPS * rows * l * d)
    dev, passes = device_split(kernel, LR_REVERSE_KERNELS)
    return dict(kernel="linear_recurrence_reverse", shape=[rows, l, d], dtype="torch.float32",
                max_abs_err=err, tol=BWD_FP32_TOL,
                window=lr_tile_layout(rows, l, d, True).window, empty_captures=empty,
                bytes=nbytes,
                ms=cuda_ms(kernel), device_ms=dev, passes=passes,
                plain_ms=cuda_ms(lambda: linear_recurrence_reverse_plain(a, h, grad),
                                 reps=3, per=3),
                bound_ms=bms, bound_by=by)


def nstate_inputs(batch, l, kd, dtype, gen):
    """The N-state kernel's inputs: u, Δ, B and C as the fused forward's
    checks draw them, dt_bias as the model initialises it, and A = −exp of
    log(1..16) moved by a seeded N(0, 0.3²), a learned-looking decay set."""
    g = torch.Generator(device="cuda").manual_seed(batch * 1_000_003 + l * 1009 + kd + 7)
    _, bias, dsk = init_ranges(kd, gen)
    u = torch.randn(batch, l, kd, device="cuda", generator=g).to(dtype)
    dts = (0.5 * torch.randn(batch, l, kd, device="cuda", generator=g)).to(dtype)
    bs = torch.randn(batch, l, K, NSTATE_N, device="cuda", generator=g).to(dtype)
    cs = torch.randn(batch, l, K, NSTATE_N, device="cuda", generator=g).to(dtype)
    logs = torch.arange(1, NSTATE_N + 1, device="cuda").log().expand(kd, NSTATE_N)
    a = -torch.exp(logs + 0.3 * torch.randn(kd, NSTATE_N, device="cuda", generator=g))
    return (u, dts, bs, cs, a, bias, dsk, K)


def profile_nstate(batch, l, kd, dtype, gen):
    """One N-state call is one kernel under the module's exported name, and
    its device time by torch.profiler: (empty captures taken again, device
    ms, passes). Every shape is profiled before any is checked: on the card
    the profiler's captures came back empty for the rest of the process
    after the batch-128 check of the first stage (its plain version and
    timing)."""
    args = nstate_inputs(batch, l, kd, dtype, gen)
    fn = lambda: selective_scan_nstate(*args)  # noqa: E731
    empty = one_kernel(f"nstate {(batch, l, kd)} {dtype}", fn, NSTATE_KERNELS,
                       selective_scan_nstate, lambda out: None)
    return (empty, *device_split(fn, NSTATE_KERNELS))


def check_nstate(batch, l, kd, dtype, gen):
    """The N-state kernel's y against its plain version (run on 16 rows at a
    time, to hold the batch-128 check's memory to a few GB); a second call
    bitwise the first; times beside the byte and exp bounds."""
    args = nstate_inputs(batch, l, kd, dtype, gen)
    name = f"nstate {(batch, l, kd)} {dtype}"
    fn = lambda: selective_scan_nstate(*args)  # noqa: E731

    def plain():
        return torch.cat([selective_scan_nstate_plain(*(t[i:i + 16] for t in args[:4]), *args[4:])
                          for i in range(0, batch, 16)])

    tol = NSTATE_BF16_TOL if dtype == torch.bfloat16 else NSTATE_FP32_TOL
    y = fn()
    check_same(name, (y,), (fn(),))
    err = check_close(name, y, plain(), tol)
    size = y.element_size()
    # u, dts read and y written; B, C read; A, bias, D_skip read.
    nbytes = (3 * batch * l * kd + 2 * batch * l * K * NSTATE_N) * size \
        + (kd * NSTATE_N + 2 * kd) * 4
    return dict(kernel="selective_scan_nstate", shape=[batch, l, kd], dtype=str(dtype),
                tile=list(nstate_tile_layout(batch, kd, K, NSTATE_N, size)),
                max_abs_err=err, tol=tol, bytes=nbytes, ms=cuda_ms(fn),
                plain_ms=cuda_ms(plain, reps=3, per=1), bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                exp_bound_ms=batch * l * kd * NSTATE_N / SFU_EXP_PER_S * 1e3)


def nstate_graph_replay(batch, l, kd, dtype, gen):
    """The N-state call captured in a CUDA graph on a side stream: its replay
    bitwise the eager call."""
    args = nstate_inputs(batch, l, kd, dtype, gen)
    y = selective_scan_nstate(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        selective_scan_nstate(*args)  # the capture stream's warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_graph = selective_scan_nstate(*args)
    graph.replay()
    torch.cuda.synchronize()
    check_same(f"nstate {(batch, l, kd)} {dtype} graph", (y,), (y_graph,))


def nstate_phase(smi):
    """Phase 18: the N-state kernel at the classifier's scan shapes, batch 8
    and 128, and at D = 33; sums over one forward's calls."""
    gen = torch.Generator().manual_seed(19)
    # The classifier's shapes; then D = 33: groups of 3 channels, staged by
    # plain loads, and L no multiple of 16.
    shapes = [(batch, l, kd, dtype) for batch, dtypes in (
        (8, (torch.bfloat16, torch.float32)), (128, (torch.bfloat16,)))
        for dtype in dtypes for (l, kd) in VSSM_SCANS]
    shapes += [(2, 1000, 132, dtype) for dtype in (torch.bfloat16, torch.float32)]
    profiled = [profile_nstate(*shape, gen) for shape in shapes]
    checks = []
    for shape, (empty, dev, passes) in zip(shapes, profiled):
        c = dict(check_nstate(*shape, gen), empty_captures=empty, device_ms=dev, passes=passes)
        checks.append(c)
        torch.cuda.empty_cache()
        print(f"{c['kernel']} {tuple(c['shape'])} {c['dtype'][6:]} tile {tuple(c['tile'])}: "
              f"max|err| {c['max_abs_err']:.3e} (tol {c['tol']}) kernel {c['ms']:.4f} ms "
              f"(device {fmt_ms(c['device_ms'])}); bitwise repeatable; one kernel per call "
              f"({c['empty_captures']} empty captures taken again), plain {c['plain_ms']:.3f} "
              f"ms, bounds: bytes {c['bound_ms']:.4f} ms ({c['bytes'] / 1e6:.2f} MB), exp "
              f"{c['exp_bound_ms']:.4f} ms", flush=True)
    for shape in shapes:
        nstate_graph_replay(*shape, gen)
    print(f"a CUDA graph's replay bitwise the eager call at each of the {len(shapes)} shapes")
    report = {"checks": checks}
    for batch in (8, 128):
        rows = {tuple(c["shape"][1:]): c for c in checks
                if c["shape"][0] == batch and c["dtype"] == "torch.bfloat16"}
        per = {key: sum(n * rows[s][key] for s, n in VSSM_SCANS.items())
               for key in ("ms", "plain_ms", "bound_ms", "exp_bound_ms")}
        dev = [rows[s]["device_ms"] for s in VSSM_SCANS]
        per["device_ms"] = None if None in dev else sum(
            n * rows[s]["device_ms"] for s, n in VSSM_SCANS.items())
        report[f"forward_batch{batch}"] = per
        print(f"N-state scan per VSSM forward (batch {batch}, bf16, "
              f"{sum(VSSM_SCANS.values())} calls): device {fmt_ms(per['device_ms'])}, wrapper "
              f"{per['ms']:.4f} ms, plain {per['plain_ms']:.2f} ms; bounds: bytes "
              f"{per['bound_ms']:.4f} ms, exp {per['exp_bound_ms']:.4f} ms  [{smi}]")
    return report


def nstate_process(smi):
    """Phase 18 in a process of its own, which returns its report: on the
    card the profiler's captures came back empty for the rest of a process
    after some phases (the trajectory phase; this phase's own batch-128
    checks, see profile_nstate), cause not found."""
    out = OUT / "nstate.json"
    code = ("import json, sys, chip_smoke as c; "
            "open(sys.argv[2], 'w').write(json.dumps(c.nstate_phase(sys.argv[1])))")
    proc = subprocess.run([sys.executable, "-c", code, smi, str(out)], cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError(f"the N-state phase's process exited {proc.returncode}")
    return json.loads(out.read_text())


# LayerNorm calls of one batch-1 forward, {(N, rows): calls}: the flagship
# generator at dims 16 and 24 (a 512 × 512 image; N = 2 is the v3 head's
# last out_norm) and VMamba-T v0 at 224² (one image). The LayerNorm phase
# checks them against each model's calls, at batch 1 and the largest batch
# each serves (LN_BATCHES: the bucket of 8, the classify cell's 128).
LN_CALLS = {
    "vmasr48k_d16": {(2, 262144): 2, (4, 262144): 2, (8, 65536): 8, (16, 16384): 12,
                     (16, 65536): 2, (32, 4096): 18, (32, 16384): 6, (64, 1024): 18,
                     (64, 4096): 10, (128, 256): 16, (128, 1024): 10, (256, 256): 10},
    "vmasr48k_d24": {(2, 262144): 2, (6, 262144): 2, (12, 65536): 8, (24, 16384): 12,
                     (24, 65536): 2, (48, 4096): 18, (48, 16384): 6, (96, 1024): 18,
                     (96, 4096): 10, (192, 256): 16, (192, 1024): 10, (384, 256): 10},
    "vssm_tiny": {(96, 3136): 3, (192, 3136): 2, (384, 784): 3, (192, 784): 2,
                  (768, 196): 10, (384, 196): 9, (1536, 49): 3, (768, 49): 3},
}
LN_BATCHES = {"vmasr48k_d16": (1, 8), "vmasr48k_d24": (1, 8), "vssm_tiny": (1, 128)}
VSSM_TINY_CONFIG = ROOT / "benchmark" / "configs" / "vssm_tiny.json"
# LayerNorm kernel against its plain version (torch's route). Both take the
# statistics and the affine in fp32 and round once; they sum in another
# order (torch by Welford) and take rsqrt on other units, ~1e-7 of the
# unit-variance output apart. fp32: rtol = atol = 1e-5 of that output, the
# atol scaled by the row's own conditioning, 1 + |gamma|·|mean| / std (in
# fp64): each rounds the mean by ~6e-8 of |mean|, and x − mean carries that
# into the output over std. A row of 2 or 4 values may spread far less than
# its mean; at 2 M rows of 4 (batch 8) such rows put the two 9e-5 apart
# on an NVIDIA H100 80GB HBM3. bf16: the two round fp32 values that close,
# so at most one bf16 ulp apart, plus the fp32 bar where the output nears 0
# (an output of 1e-5 has ulps of 6e-8, finer than the fp32 values' gap).
LN_BF16_ULPS = 1
LN_FP32_TOL = dict(rtol=1e-5, atol=1e-5)
LN_EPS = 1e-5
LN_NAMES = frozenset(LAYER_NORM_KERNELS["norm"])
# torch's LayerNorm kernels, which the forward without a gradient no longer runs.
TORCH_LN_KERNELS = ("vectorized_layer_norm_kernel", "RowwiseMomentsCUDAKernel",
                    "LayerNormForwardCUDAKernel")


def torch_ln_events(events) -> int:
    return sum(any(k in name for k in TORCH_LN_KERNELS) for name, _, _ in events)


def ln_events(events) -> int:
    return sum(name in LN_NAMES for name, _, _ in events)


def ln_models():
    """{label: (bf16 model, inputs of a batch)} of the three censuses: the
    flagship generator at dims 16 and 24 (a segment of speech-like audio)
    and VMamba-T v0 (the classify cell's configuration, seeded weights)."""
    d24 = load_config(str(ROOT / "configs" / DIMS24_YAML), [
        "AMP_ENABLE", "True", "OUTPUT", str(OUT / "logs"), "TAG", "16000_48000"])
    tiny = default_config()
    tiny.merge_from_dict(json.loads(VSSM_TINY_CONFIG.read_text())["program"])
    tiny.OUTPUT = str(OUT / "logs")
    tiny.freeze()
    models = {}
    for label, cfg in (("vmasr48k_d16", flagship_config(amp=True)), ("vmasr48k_d24", d24)):
        seg = int(cfg.DATA.SEGMENT * cfg.DATA.TARGET_SR)
        wave = torch.from_numpy(speech_like(seg / 48000, 48000, seed=3)).cuda()
        models[label] = (get_generator(cfg, "cuda"), lambda b, wave=wave: (
            wave.expand(b, 1, -1).contiguous(), torch.full((b,), 171, device="cuda")))
    gen = torch.Generator(device="cuda").manual_seed(5)
    image = torch.randn(1, VSSM_IMAGE, VSSM_IMAGE, 3, device="cuda", generator=gen)
    models["vssm_tiny"] = (build_classifier(tiny, "cuda", seed=0),
                           lambda b: (image.expand(b, -1, -1, -1).contiguous(),))
    return models


def ln_census(model, inputs):
    """One forward without a gradient: its LayerNorm calls {(N, rows):
    calls}, the kernel's launches, and its device events (profiled)."""
    seen = Counter()
    hooks = [m.register_forward_pre_hook(lambda mod, inp: seen.update(
        [(inp[0].shape[-1], inp[0].numel() // inp[0].shape[-1])]))
        for m in model.modules() if isinstance(m, LayerNorm)]
    before = layer_norm.launches
    with torch.inference_mode():
        model(*inputs)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    launches = layer_norm.launches - before
    with torch.inference_mode():
        events = device_kernels(lambda: model(*inputs))
    return dict(seen), launches, events


def bf16_ulp(t):
    """The spacing of bf16 values at |t|, elementwise (t bf16), in fp32."""
    mag = t.abs()
    return (mag.view(torch.int16) + 1).view(torch.bfloat16).float() - mag.float()


def ln_inputs(rows, n, dtype, gen):
    """Rows of mean ~N(0, 16) and scale 3, and an affine ~N(0, 1), on the card."""
    x = torch.randn(rows, n, device="cuda", generator=gen) * 3 \
        + torch.randn(rows, 1, device="cuda", generator=gen) * 4
    return (x.to(dtype), torch.randn(n, device="cuda", generator=gen),
            torch.randn(n, device="cuda", generator=gen))


def check_layer_norm(rows, n, dtype, gen):
    """The kernel against its plain version at one (rows, N), elementwise:
    in fp32 within LN_FP32_TOL (its atol scaled by the row's conditioning),
    in bf16 within one ulp and that atol; the share of elements that differ;
    a second call bitwise the first."""
    x, w, b = ln_inputs(rows, n, dtype, gen)
    y = layer_norm(x, w, b, LN_EPS, dtype)
    check_same(f"layer_norm {(rows, n)} {dtype}", (y,), (layer_norm(x, w, b, LN_EPS, dtype),))
    p = layer_norm_plain(x, w, b, LN_EPS, dtype)
    xd = x.double()
    mean, std = xd.mean(-1, keepdim=True), xd.std(-1, correction=0, keepdim=True)
    atol = LN_FP32_TOL["atol"] * (1 + w.double().abs() * mean.abs() / std)
    gap = (y.double() - p.double()).abs()
    if dtype == torch.bfloat16:
        bar = LN_BF16_ULPS * bf16_ulp(p).double() + atol
        away = p.abs() >= 2.0 ** -6  # ulps there at least 2^-13, far above fp32's gap
        err = (gap / bf16_ulp(p).double())[away].max().item()
    else:
        bar = atol + LN_FP32_TOL["rtol"] * p.double().abs()
        err = gap.max().item()
    of_bar, differ = (gap / bar).max().item(), (gap > 0).double().mean().item()
    del xd, mean, std, atol, gap, bar
    if not of_bar <= 1:
        raise AssertionError(f"layer_norm {(rows, n)} {dtype}: kernel vs plain at {of_bar:.3g} "
                             f"of the bar; {'ulps (|plain| >= 2^-6)' if dtype == torch.bfloat16 else 'max |diff|'} {err:.3g}")
    size = x.element_size()
    nbytes = 2 * rows * n * size + 2 * n * 4
    return dict(kernel="layer_norm", shape=[rows, n], dtype=str(dtype),
                plan=list(layer_norm_plan(rows, n, size)), max_err=err, of_bar=of_bar,
                differ_share=differ,
                bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def ln_device_ms(rows_list, dtype, gen, reps: int = 10, tries: int = 3):
    """Device ms a call of the kernel and of torch's route (the plain
    version, `library_ms`) at each (rows, N) of ``rows_list``: kernels only,
    no gaps, from one profiled pass over the shapes, each route's calls
    between spin kernels; None where a capture dropped events."""
    args = [ln_inputs(r, n, dtype, gen) for r, n in rows_list]

    def run():
        for x, w, b in args:
            torch.cuda._sleep(100)
            for _ in range(reps):
                layer_norm(x, w, b, LN_EPS, dtype)
            torch.cuda._sleep(100)
            for _ in range(reps):
                layer_norm_plain(x, w, b, LN_EPS, dtype)

    for _ in range(tries):
        segs, cur = [], None
        for name, s_, e_ in sorted(device_kernels(run), key=lambda e: e[1]):
            if "spin_kernel" in name:
                cur = []
                segs.append(cur)
            elif cur is not None:
                cur.append((name, s_, e_))
        if len(segs) == 2 * len(args) and all(
                len(k) == reps and all(n_ in LN_NAMES for n_, _, _ in k) for k in segs[::2]):
            return [(sum(e_ - s_ for _, s_, e_ in k) / reps / 1e3,
                     sum(e_ - s_ for _, s_, e_ in lib) / reps / 1e3)
                    for k, lib in zip(segs[::2], segs[1::2])]
    return [(None, None)] * len(args)


def layer_norm_phase(smi):
    """The LayerNorm kernel on the main path: against its plain version at
    every census shape, batch 1 and the largest, bf16 and fp32, with device
    ms beside the byte bound and torch's route (library_ms), summed over a
    forward's calls; then each census against the models' own calls, 114
    launches a generator forward and 35 a classifier forward at batch 1 and
    2, the forward's device events all the kernel's and none of torch's
    LayerNorm. In a process of its own (layer_norm_process)."""
    report = dict(checks=[], per_forward={}, census={})
    gen = torch.Generator(device="cuda").manual_seed(7)
    for label, calls in LN_CALLS.items():
        for batch in LN_BATCHES[label]:
            shapes = [(r * batch, n) for n, r in calls]
            for dtype in (torch.bfloat16, torch.float32):
                rows = [check_layer_norm(r, n, dtype, gen) for r, n in shapes]
                for c, (ms, lib) in zip(rows, ln_device_ms(shapes, dtype, gen)):
                    c.update(config=label, batch=batch, device_ms=ms, library_ms=lib,
                             plain_ms=lib)
                    print(f"layer_norm {label} batch {batch} {tuple(c['shape'])} "
                          f"{c['dtype'][6:]}: {c['of_bar']:.3f} of the bar, "
                          f"{'ulps' if dtype == torch.bfloat16 else 'max|err|'} {c['max_err']:.3g},"
                          f" {100 * c['differ_share']:.2f} % differ; device {fmt_ms(ms)}, torch's "
                          f"route {fmt_ms(lib)}, bound {c['bound_ms']:.4f} ms; plan {c['plan']}")
                    # The census runs bf16: there the kernel must not be slower.
                    if dtype == torch.bfloat16 and ms is not None and not ms <= lib:
                        raise AssertionError(f"layer_norm {c['shape']} {dtype}: kernel {ms} ms "
                                             f"slower than torch's route {lib} ms")
                report["checks"] += rows
                per = {key: None if any(c[key] is None for c in rows) else sum(
                    calls[(c["shape"][1], c["shape"][0] // batch)] * c[key] for c in rows)
                    for key in ("device_ms", "library_ms", "bound_ms")}
                report["per_forward"][f"{label}/{batch}/{str(dtype)[6:]}"] = per
                print(f"layer_norm per {label} forward, batch {batch}, {str(dtype)[6:]}: device "
                      f"{fmt_ms(per['device_ms'])}, torch's route {fmt_ms(per['library_ms'])}, "
                      f"bound {per['bound_ms']:.4f} ms  [{smi}]")
    for label, (model, inputs) in ln_models().items():
        want_launches = sum(LN_CALLS[label].values())
        for batch in (1, 2):
            seen, launches, events = ln_census(model, inputs(batch))
            want = {(n, r * batch): c for (n, r), c in LN_CALLS[label].items()}
            row = dict(batch=batch, launches=launches, device_ln_calls=ln_events(events),
                       torch_ln_events=torch_ln_events(events), device_events=len(events))
            print(f"{label} batch {batch}: {launches} LayerNorm launches, on the device "
                  f"{row['device_ln_calls']} kernel calls and {row['torch_ln_events']} of "
                  f"torch's LayerNorm kernels ({len(events)} device events); calls by (N, "
                  f"rows) {'as the census' if seen == want else seen}")
            odd = sorted({n for n, _, _ in events if "layer_norm" in n and n not in LN_NAMES})
            if seen != want or launches != want_launches or row["torch_ln_events"] or (
                    events and row["device_ln_calls"] != want_launches) or odd:
                raise AssertionError(f"{label} batch {batch}: {row}; unknown kernel names {odd}")
            report["census"][f"{label}/{batch}"] = row
        del model
    return report


def layer_norm_process(smi):
    """layer_norm_phase in a process of its own, which returns its report:
    it profiles after running the classifier, after which, as after the
    N-state phase's checks (nstate_process), the profiler's captures may
    come back empty for the rest of a process."""
    out = OUT / "layer_norm.json"
    code = ("import json, sys, chip_smoke as c; "
            "open(sys.argv[2], 'w').write(json.dumps(c.layer_norm_phase(sys.argv[1])))")
    proc = subprocess.run([sys.executable, "-c", code, smi, str(out)], cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError(f"the LayerNorm phase's process exited {proc.returncode}")
    return json.loads(out.read_text())


def route_host_us(gen, rounds: int = 4, calls: int = 50):
    """Host µs per call of each kernel wrapper by its two routes: the autograd
    Function (every block that is not checkpointed) and the dispatcher op
    (checkpointed blocks), at the flagship train step's bf16 batch-4 shapes
    with inputs that need a gradient; the forward alone and the forward with
    its backward (torch.autograd.grad). Each time is the host's clock over
    ``calls`` calls, taken before the device is waited for; the routes
    alternate, and which goes first alternates from round to round. Medians
    over the rounds, and the sum over one step's calls."""
    cases = []
    for (l, kd) in FUSED_CALLS:
        args, dy = fused_inputs(TRAIN_BATCH, l, kd, torch.bfloat16, gen)
        for t in args[:7]:
            t.requires_grad_(True)
        cases.append((f"fused {(TRAIN_BATCH, l, kd)}", FUSED_CALLS[(l, kd)], args[:7], dy,
                      lambda as_op, args=args: selective_scan_fused(*args, as_op=as_op)))
    for (l, d) in LR_CALLS:
        a, b, _, dy = lr_inputs(TRAIN_BATCH, l, d, gen, 1_000_037)
        a.requires_grad_(True)
        b.requires_grad_(True)
        cases.append((f"recurrence {(TRAIN_BATCH, l, d)}", LR_CALLS[(l, d)], (a, b), dy,
                      lambda as_op, a=a, b=b: linear_recurrence(a, b, as_op=as_op)))

    def host_us(fn, inputs, dy):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        fwd = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            torch.autograd.grad(fn(), inputs, dy)
        both = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
        return fwd, both

    out = {}
    for name, per_step, inputs, dy, fn in cases:
        runs = {False: [], True: []}
        for as_op in (False, True):  # warm-up
            host_us(lambda: fn(as_op), inputs, dy)
        for r in range(rounds):
            for as_op in ((False, True) if r % 2 == 0 else (True, False)):
                runs[as_op].append(host_us(lambda: fn(as_op), inputs, dy))
        out[name] = dict(calls_per_step=per_step, **{
            f"{route}_{part}_us": statistics.median(x[i] for x in runs[as_op])
            for route, as_op in (("function", False), ("op", True))
            for i, part in enumerate(("fwd", "fwd_bwd"))})
    for part in ("fwd", "fwd_bwd"):
        out[f"step_{part}_delta_us"] = sum(
            c["calls_per_step"] * (c[f"op_{part}_us"] - c[f"function_{part}_us"])
            for c in out.values() if isinstance(c, dict))
    return out


def route_step_ms(model, run, rounds: int = 4, per: int = 3):
    """The flagship train step (CUDA events, synchronised per step) with every
    SS2D's scans on the autograd Functions (the main path) and on the
    dispatcher ops (the route of a checkpointed block, here without the
    checkpoint), alternating as route_host_us does; medians per route."""
    ss2d = [m for m in model.modules() if isinstance(m, SS2D)]
    times = {False: [], True: []}
    for r in range(rounds):
        for flag in ((False, True) if r % 2 == 0 else (True, False)):
            for m in ss2d:
                m.checkpointed = flag
            for i in range(per):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                run(i)
                end.record()
                torch.cuda.synchronize()
                times[flag].append(start.elapsed_time(end))
    for m in ss2d:
        m.checkpointed = False
    return dict(function_ms=statistics.median(times[False]),
                op_ms=statistics.median(times[True]), steps_per_route=rounds * per)


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


def sampler_times(cfg, draws: int = 8):
    """Host seconds of one DegradingSampler.sample of a flagship training
    item at input rates drawn as the config draws them (uniform over
    RANDOM_RESAMPLE, here 8000..48000 Hz), one per seed; and of a whole
    DataPipeline pass (five batches of four, DATA.NUM_WORKERS 4 threads) at
    such rates, the items synthesised beforehand."""
    ds = SyntheticVCTK(n_items=20, sr=cfg.DATA.TARGET_SR, duration=cfg.DATA.SEGMENT + 0.05)
    for i in range(len(ds)):
        ds.load(i)  # synthesis is memoised; time the degradation
    sampler = DegradingSampler(ds, cfg, training=True)
    out = []
    for seed in range(draws):
        rate = sampler._draw_input_sr(np.random.default_rng([seed, 0]))
        t = time.perf_counter()
        sampler.sample(0, np.random.default_rng([seed, 0]))
        out.append((rate, time.perf_counter() - t))
    t = time.perf_counter()
    n = sum(1 for _ in DataPipeline(sampler, batch_size=TRAIN_BATCH, num_workers=4))
    return out, n, time.perf_counter() - t


def cli_phase(smi: str, bare_idle):
    """Train, resume, eval and throughput through vm_asr_tpu_torch.cli.run,
    in-process, with exact launch counts; returns (report, launches of the
    first training run)."""
    cfg = flagship_config(amp=True, gan=True)
    rates, n_batches, pipe_s = sampler_times(cfg)
    for rate, sec in rates:
        print(f"DegradingSampler.sample at a drawn input rate of {rate} Hz: {sec:.3f} s "
              f"(host)  [{smi}]")
    print(f"DataPipeline at drawn input rates: {n_batches} batches of {TRAIN_BATCH} in "
          f"{pipe_s:.3f} s, {pipe_s / n_batches:.3f} s a batch (4 threads, host)  [{smi}]")
    work = OUT / "cli"  # the working directory: the Tester's CSV lands here
    runs = ROOT / "build" / "chip_smoke_cli"  # checkpoints, ~1 GB a save: not in OUT
    for d in (work, runs):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    base = ["--cfg", str(CONFIG), "--tag", "chip", "--input_sr", "16000", "--synthetic_data",
            "--synthetic_n", "24"]
    opts = ["DATA.VALID_SPLIT", "0.2", "DATA.NUM_WORKERS", "4", "TENSORBOARD.ENABLE", "False",
            "OUTPUT", str(runs)]
    run_dir = runs / "DualStreamInteractiveMambaUNet" / "chip"
    cwd = os.getcwd()
    os.chdir(work)
    try:
        # 1. train one epoch
        zero_counts()
        mode, trainer = cli.run(base + ["--opts", "TRAIN.EPOCHS", "1"] + opts)
        train_counts = read_counts()
        first = trainer.timings[-1]
        n, v = first["steps"], len(trainer.valid_loader)
        want = dict(selective_scan_fused=30 * (n + v), selective_scan_fused_bwd=30 * n,
                    linear_recurrence=4 * (n + v), linear_recurrence_reverse=4 * n)
        files = sorted(p.name for p in run_dir.glob("checkpoint-*.pth"))
        sizes = {p.name: p.stat().st_size for p in run_dir.glob("checkpoint-*.pth")}
        print(f"cli train: mode {mode}, {n} steps, {v} validation batch(es), launches "
              f"{train_counts}, checkpoints {sizes}")
        if (mode, n, v) != ("train", 5, 1) or train_counts != want or files != [
                f"checkpoint-{k}-{m}.pth" for k in ("best", "latest") for m in ("G", "mpd")]:
            raise AssertionError(f"cli train: want 5 steps, 1 validation batch, launches "
                                 f"{want} and best/latest checkpoints; got {n}, {v}, "
                                 f"{train_counts}, {files}")
        steps = first["step_s"]
        print(f"cli train: {statistics.median(steps):.4f} s/it median over {n} steps "
              f"(min {min(steps):.4f}, max {max(steps):.4f}; host clock, the first step "
              f"cold; {statistics.median(steps[1:]):.4f} over steps 2..{n}), data wait "
              f"{first['data_wait_s'][0]:.4f} s for the first batch and "
              f"{sum(first['data_wait_s'][1:]):.4f} s for the rest, epoch "
              f"{first['epoch_s']:.3f} s, validation {first['valid_s']:.3f} s, checkpoint "
              f"writes {first['save_ms']:.1f} ms for {sum(sizes.values()) / 1e9:.3f} GB  "
              f"[{smi}]")
        del trainer

        # 2. resume for a second epoch, its second step profiled
        zero_counts()
        mode, trainer = cli.run(base + ["--opts", "TRAIN.EPOCHS", "2", "PROFILE_STEPS", "1"]
                                + opts)
        resume_counts = read_counts()
        second = trainer.timings[-1]
        counts = {name: s.optimizer.count for name, s in
                  [("G", trainer.gen_state)] + list(trainer.disc_states.items())}
        print(f"cli resume: start epoch {trainer.start_epoch}, {second['steps']} steps, "
              f"optimizer counts {counts}, generator step {trainer.gen_state.step}, "
              f"launches {resume_counts}")
        if (trainer.start_epoch, second["steps"], trainer.gen_state.step) != (1, n, 2 * n) or \
                set(counts.values()) != {2 * n} or resume_counts != want:
            raise AssertionError("cli resume did not continue from epoch 1 and count "
                                 f"{n}: {counts}, {resume_counts}")
        prof = second["profile"]
        steps2 = second["step_s"]
        print(f"cli resume: {statistics.median(steps2):.4f} s/it median (min "
              f"{min(steps2):.4f}, max {max(steps2):.4f}; step 2 profiled and its trace "
              f"written; {statistics.median(steps2[2:]):.4f} over steps 3..{n}), epoch "
              f"{second['epoch_s']:.3f} s, validation {second['valid_s']:.3f} s, checkpoint "
              f"writes {second['save_ms']:.1f} ms  [{smi}]")
        # As the train phase takes its idle share: busy time over the median
        # of the unprofiled steps (the profiler lengthens the step it traces).
        busy = prof["device_busy_ms"]
        warm_ms = 1e3 * statistics.median(steps2[2:])
        idle = "not measured" if busy is None else f"{1 - busy / warm_ms:.3f}"
        traced = "not measured" if busy is None else f"{prof['idle_share']:.3f}"
        bare = "not measured" if bare_idle is None else f"{bare_idle:.3f}"
        print(f"cli profiled step: device busy {fmt_ms(busy)} in {prof['device_events']} "
              f"device events; idle share {idle} of the median unprofiled step "
              f"({warm_ms:.2f} ms; the train phase's bare step: {bare}), {traced} of the "
              f"traced step's own wall ({prof['wall_ms']:.2f} ms)  [{smi}]")
        shutil.copy(run_dir / "log_rank0.txt", work / "train_log_rank0.txt")
        del trainer

        # 3. evaluate the best checkpoint on four clips of two segments
        zero_counts()
        mode, tester = cli.run(["--cfg", str(CONFIG), "--eval", "--tag", "16000_48000",
                                "--resume", str(run_dir), "--synthetic_data", "--synthetic_n",
                                "4", "--opts", "TENSORBOARD.ENABLE", "False",
                                "TEST.RESULTS_DIR", str(work / "results")])
        eval_counts = read_counts()
        shapes = {tester._num_segments(r["samples"]) for r in tester.rows}
        # The clips, a warm-up and the measurement run one signature (bucket
        # 2): the host launches its eager first call and its capture.
        eval_want = forward_counts(2)
        with open(work / "results_48kHz.csv") as f:
            table = list(csv.reader(f))
        header = [c.upper() for c in tester_module.CSV_COLUMNS + tester_module.COMPUTE_COLUMNS]
        values = [float(x) for x in table[1]] if len(table) == 2 else []
        for r in tester.rows:
            print(f"cli eval {r['name']}: rtf {r['rtf']:.4f}, rtf_compute "
                  f"{r['rtf_compute']:.4f}, snr {r['snr']:.3f}, lsd {r['lsd']:.3f} "
                  f"(lsd_input {r['lsd_input']:.3f})  [{smi}]")
        print(f"cli eval: {len(tester.rows)} clips of {shapes} segments, launches "
              f"{eval_counts}; csv {table}")
        if mode != "eval" or len(tester.rows) != 4 or shapes != {2} or \
                issued_forwards(tester.forward) != 2 or eval_counts != eval_want or \
                table[0] != header or len(values) != 9 or not np.isfinite(values).all():
            raise AssertionError(f"cli eval: want 4 two-segment clips, launches {eval_want} "
                                 f"and one finite 9-column CSV row; got {eval_counts}, {table}")

        # 4. throughput at batch 4
        zero_counts()
        mode, stats = cli.run(["--cfg", str(CONFIG), "--throughput", "--batch_size", "4",
                               "--opts", "TENSORBOARD.ENABLE", "False", "OUTPUT", str(runs)])
        tp_counts = read_counts()
        # First call, warm-up, windows × (N + 2N) at N = 10, of one signature:
        # the host launches its eager first call and its capture.
        calls = 1 + 2 + 3 * 3 * 10
        print(f"cli throughput: {stats['segments_per_second']:.2f} segments/s, "
              f"{stats['x_real_time']:.2f}x real time at batch {stats['batch']} "
              f"({stats['seconds_per_call'] * 1e3:.2f} ms a call, CUDA events); launches "
              f"{tp_counts}  [{smi}]")
        if mode != "throughput" or stats["batch"] != 4 or tp_counts != forward_counts(2):
            raise AssertionError(f"cli throughput: launches {tp_counts} for {calls} calls of "
                                 f"one signature (want {forward_counts(2)})")
    finally:
        os.chdir(cwd)
    report = dict(sampler=rates, pipeline=dict(batches=n_batches, seconds=pipe_s),
                  checkpoint_bytes=sizes, train=first, resume=second, eval_rows=tester.rows,
                  eval_csv=table, throughput=stats, launches=dict(
                      train=train_counts, resume=resume_counts, eval=eval_counts,
                      throughput=tp_counts))
    return report, train_counts


RAW_SPEAKERS = ("p225", "p226", "p227", "p280")  # p280: skipped by the conversion
RAW_UTTERANCES = 12  # two training speakers: 20 train items (5 steps) and 4 valid
RAW_SECONDS = 3.0
RAW_TRIM = (0.10, 2.90)  # each utterance's silence-label window, seconds


def write_flac_corpus(data_path: Path):
    """A VCTK-0.92-shaped FLAC tree, 16-bit at 48 kHz, written by the repo's
    pure-Python encoder (tests/flac_ref.py), and its silence-labels file.
    Returns ({relative path: PCM}, labels path, seconds)."""
    # By path: the card's machine may have a package named "tests" installed.
    spec = importlib.util.spec_from_file_location("flac_ref", ROOT / "tests" / "flac_ref.py")
    flac_ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(flac_ref)

    t0 = time.perf_counter()
    flac_root = data_path / "VCTK-Corpus-0.92" / "wav48_silence_trimmed"
    pcm, rows = {}, []
    for s, spk in enumerate(RAW_SPEAKERS):
        (flac_root / spk).mkdir(parents=True)
        for u in range(1, RAW_UTTERANCES + 1):
            x = np.round(speech_like(RAW_SECONDS, 48000, seed=100 * s + u) * 32767)
            rel = f"{spk}/{spk}_{u:03d}_mic1.flac"
            pcm[rel] = x.astype(np.int64)
            # One file with fixed-predictor subframes and Rice residuals; the
            # rest verbatim (the encoder is pure Python, ~30x slower).
            kw = dict(mode="fixed2", rice_param=10) if (s, u) == (0, 1) else dict(mode="verbatim")
            (flac_root / rel).write_bytes(flac_ref.encode_flac(pcm[rel][None], 48000,
                                                               blocksize=4096, **kw))
            rows.append(f"{spk}_{u:03d} {RAW_TRIM[0]:.2f} {RAW_TRIM[1]:.2f}\n")
    labels = data_path / "vctk-silences.0.92.txt"
    labels.write_text("".join(rows))
    return pcm, labels, time.perf_counter() - t0


def scipy_resample(x, up, down):
    """The scipy path the port took before the host library (``resample_poly``
    along the last axis, cast to float32)."""
    from scipy.signal import resample_poly

    return resample_poly(x, up, down, axis=-1).astype(np.float32, copy=False)


def sample_native_vs_scipy(sampler, draws: int = 8):
    """DegradingSampler.sample of one item at the eight input rates drawn as
    sampler_times draws them: host seconds with the C++ resampler and with
    scipy's, and the largest |difference| of the degraded inputs."""
    from vm_asr_tpu_torch.data import native

    rows = []
    for seed in range(draws):
        rate = sampler._draw_input_sr(np.random.default_rng([seed, 0]))
        t = time.perf_counter()
        x_nat = sampler.sample(0, np.random.default_rng([seed, 0]))[0]
        t_nat = time.perf_counter() - t
        orig, native.resample_poly = native.resample_poly, scipy_resample
        try:
            t = time.perf_counter()
            x_sci = sampler.sample(0, np.random.default_rng([seed, 0]))[0]
            t_sci = time.perf_counter() - t
        finally:
            native.resample_poly = orig
        rows.append(dict(rate=rate, native_s=t_nat, scipy_s=t_sci,
                         max_abs_diff=float(np.abs(x_nat - x_sci).max())))
    return rows


def pipeline_seconds(sampler, batch: int, n_items: int):
    """Host seconds a batch of the threads and the worker-process pipelines
    over ``n_items`` items (the corpus repeated), 4 threads or workers, and
    the first batch's wait."""
    from vm_asr_tpu_torch.data import WorkerPipeline

    out = {}
    indices = [i % len(sampler.dataset) for i in range(n_items)]
    for name, cls in (("threads", DataPipeline), ("workers", WorkerPipeline)):
        pipe = cls(sampler, batch_size=batch, indices=indices, num_workers=4, seed=5)
        t0 = time.perf_counter()
        first, n = None, 0
        for _ in pipe:
            n += 1
            first = first or time.perf_counter() - t0
        total = time.perf_counter() - t0
        out[name] = dict(batches=n, seconds=total, per_batch=total / n, first_batch=first)
    return out


def raw_corpus_phase(smi: str):
    """From a raw VCTK-0.92-shaped FLAC tree through the port's CLI: write
    the tree, decode it bitwise with the host C++ library, time the
    degradation (C++ against scipy) and the two pipelines, train the
    flagship one epoch with DATA.PIPELINE grain (the worker pipeline) from
    the tree, converted by get_loaders, then --eval on the held-out
    speaker's converted clips; exact launch counts. Returns (report, the
    training run's launches)."""
    from vm_asr_tpu_torch.data import VCTKDataset, vctk

    t0 = time.perf_counter()
    native.load()  # built in the build phase

    work = OUT / "raw"  # the working directory: the Tester's CSV lands here
    data = ROOT / "build" / "chip_smoke_raw" / "data"  # ~14 MB of FLAC, ~13 MB of wav
    runs = ROOT / "build" / "chip_smoke_raw" / "runs"  # checkpoints, ~1 GB a save
    for d in (work, data.parent):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    pcm, labels, write_s = write_flac_corpus(data)
    flac_root = data / "VCTK-Corpus-0.92" / "wav48_silence_trimmed"
    flac_bytes = sum((flac_root / rel).stat().st_size for rel in pcm)
    print(f"corpus: {len(pcm)} FLAC files ({len(RAW_SPEAKERS)} speakers x {RAW_UTTERANCES}, "
          f"{RAW_SECONDS} s each at 48 kHz, 16-bit), {flac_bytes / 1e6:.2f} MB, written in "
          f"{write_s:.2f} s (tests/flac_ref.py, host)  [{smi}]")

    decode_s = 0.0
    for rel, want in pcm.items():
        t = time.perf_counter()
        audio, sr = native.decode_flac(str(flac_root / rel))
        decode_s += time.perf_counter() - t
        if sr != 48000 or audio.shape != (1, want.size) or \
                not np.array_equal(audio[0] * 32768.0, want):
            raise AssertionError(f"decode {rel}: not the encoder's PCM bit for bit")
    pcm_bytes = 2 * sum(x.size for x in pcm.values())
    print(f"decode: {len(pcm)} files bitwise the encoder's PCM; {flac_bytes / 1e6:.2f} MB of "
          f"FLAC ({pcm_bytes / 1e6:.2f} MB of PCM) in {decode_s:.3f} s, "
          f"{flac_bytes / 1e6 / decode_s:.1f} MB/s of FLAC (host)  [{smi}]")

    cfg = flagship_config(amp=True, gan=True)
    probe = data.parent / "probe"  # the degradation and the pipelines read a converted copy
    n_conv = vctk.convert_flac_corpus(str(flac_root), str(probe), str(labels))
    ds = VCTKDataset(str(probe), train_split=(3, 0))
    sampler = DegradingSampler(ds, cfg, training=True)
    degrade = sample_native_vs_scipy(sampler)
    for r in degrade:
        print(f"DegradingSampler.sample at a drawn input rate of {r['rate']} Hz: native "
              f"{r['native_s']:.4f} s, scipy {r['scipy_s']:.4f} s, max |native - scipy| "
              f"{r['max_abs_diff']:.3e} (host)  [{smi}]")
    worst = max(r["max_abs_diff"] for r in degrade)
    if n_conv != 3 * RAW_UTTERANCES or len(ds) != n_conv or not worst <= NATIVE_TOL:
        raise AssertionError(f"degradation: {n_conv} converted, {len(ds)} items, native vs "
                             f"scipy {worst:.3e} (bar {NATIVE_TOL})")
    pipes = {}
    for batch in (TRAIN_BATCH, 24):
        pipes[batch] = pipeline_seconds(sampler, batch, n_items=4 * len(ds))
        for name, r in pipes[batch].items():
            print(f"pipeline {name}, batch {batch}, 4 {'threads' if name == 'threads' else 'worker processes'}: "
                  f"{r['batches']} batches in {r['seconds']:.3f} s, {r['per_batch']:.4f} s a "
                  f"batch (first batch {r['first_batch']:.3f} s; host)  [{smi}]")

    # Train the flagship from the FLAC tree: get_loaders converts it.
    timed = {}
    convert = vctk.convert_flac_corpus

    def timed_convert(*a, **kw):
        t = time.perf_counter()
        n = convert(*a, **kw)
        timed.update(files=n, seconds=time.perf_counter() - t)
        return n

    opts = ["DATA.DATA_PATH", f"{data}/", "DATA.FLAC2WAV.TIMESTAMPS", str(labels),
            "DATA.TRAIN_SPLIT", "[2,1]", "DATA.USE_QUANTITY", "1.0", "DATA.PIPELINE", "grain",
            "DATA.NUM_WORKERS", "4", "DATA.VALID_SPLIT", "0.2", "TENSORBOARD.ENABLE", "False",
            "OUTPUT", str(runs)]
    run_dir = runs / "DualStreamInteractiveMambaUNet" / "raw"
    wav_root = data / "VCTK-Corpus-0.92" / "wav48_silence_trimmed_wav"
    cwd = os.getcwd()
    os.chdir(work)
    vctk.convert_flac_corpus = timed_convert
    try:
        zero_counts()
        mode, trainer = cli.run(["--cfg", str(CONFIG), "--tag", "raw", "--opts",
                                 "TRAIN.EPOCHS", "1", "PROFILE_STEPS", "1"] + opts)
        train_counts = read_counts()
    finally:
        vctk.convert_flac_corpus = convert
        os.chdir(cwd)
    timing = trainer.timings[-1]
    n, v = timing["steps"], len(trainer.valid_loader)
    want = dict(selective_scan_fused=30 * (n + v), selective_scan_fused_bwd=30 * n,
                linear_recurrence=4 * (n + v), linear_recurrence_reverse=4 * n)
    converted = sorted(str(p.relative_to(wav_root)) for p in wav_root.rglob("*.wav"))
    log = trainer.train_metrics.result()
    files = sorted(p.name for p in run_dir.glob("checkpoint-*.pth"))
    print(f"raw train: converted {timed.get('files')} files in {timed.get('seconds', 0):.3f} s "
          f"(get_loaders, {len(converted)} wavs, p280 skipped); {type(trainer.train_loader).__name__}"
          f", {n} steps, {v} validation batch(es), launches {train_counts}; total loss "
          f"{log.get('total_loss', float('nan')):.4f}  [{smi}]")
    want_wavs = sorted(f"{spk}/{spk}_{u:03d}.wav" for spk in RAW_SPEAKERS[:3]
                       for u in range(1, RAW_UTTERANCES + 1))
    if (mode, n, v) != ("train", 5, 1) or train_counts != want or converted != want_wavs or \
            timed.get("files") != len(want_wavs) or \
            not Path(f"{wav_root}.converted").is_file() or \
            type(trainer.train_loader).__name__ != "WorkerPipeline" or \
            not all(np.isfinite(x) for x in log.values()) or \
            files != [f"checkpoint-{k}-{m}.pth" for k in ("best", "latest") for m in ("G", "mpd")]:
        raise AssertionError(f"raw train: want 5 steps, 1 validation batch, launches {want}, "
                             f"the converted tree, the worker pipeline, finite logs and "
                             f"checkpoints; got {mode}, {n}, {v}, {train_counts}, "
                             f"{len(converted)} wavs, {files}, {log}")
    steps, waits = timing["step_s"], timing["data_wait_s"]
    prof = timing["profile"]
    warm = steps[2:]  # the first step is cold, the second profiled
    busy = prof["device_busy_ms"]
    warm_ms = 1e3 * statistics.median(warm)
    idle = "not measured" if busy is None else f"{1 - busy / warm_ms:.3f}"
    print(f"raw train: {statistics.median(warm):.4f} s/it median over the warm steps 3..{n} "
          f"(first {steps[0]:.4f} s, profiled {steps[1]:.4f} s; host clock), data wait "
          f"{waits[0]:.4f} s for the first batch and {statistics.mean(waits[1:]):.4f} s a step "
          f"after; epoch {timing['epoch_s']:.3f} s, validation {timing['valid_s']:.3f} s, "
          f"checkpoint writes {timing['save_ms']:.1f} ms  [{smi}]")
    print(f"raw train profiled step: device busy {fmt_ms(busy)} in {prof['device_events']} "
          f"device events; idle share {idle} of the median warm step ({warm_ms:.2f} ms), "
          f"{'not measured' if busy is None else '%.3f' % prof['idle_share']} of the traced "
          f"step's own wall ({prof['wall_ms']:.2f} ms)  [{smi}]")
    del trainer

    # Evaluate the best checkpoint on the held-out speaker's converted clips.
    os.chdir(work)
    try:
        zero_counts()
        mode, tester = cli.run(["--cfg", str(CONFIG), "--eval", "--tag", "16000_48000",
                                "--resume", str(run_dir), "--opts",
                                "TEST.RESULTS_DIR", str(work / "results")] + opts)
        eval_counts = read_counts()
    finally:
        os.chdir(cwd)
    segs = {tester._num_segments(r["samples"]) for r in tester.rows}
    keys = len(segment_bucket_counts(max(segs))) if segs and max(segs) > 1 else 1
    # Each signature's eager first call and its capture; a replay launches
    # nothing from the host.
    eval_want = forward_counts(issued_forwards(tester.forward))
    names = sorted(r["name"] for r in tester.rows)
    rtf = [r["rtf"] for r in tester.rows]
    rtf_c = [r["rtf_compute"] for r in tester.rows]
    print(f"raw eval: {len(tester.rows)} clips of {segs} segments ({names[0]}..{names[-1]}), "
          f"RTF median {statistics.median(rtf):.4f} (min {min(rtf):.4f}, max {max(rtf):.4f}), "
          f"rtf_compute median {statistics.median(rtf_c):.4f}; launches {eval_counts}  [{smi}]")
    if mode != "eval" or len(tester.rows) != RAW_UTTERANCES or len(segs) != 1 or \
            not all(x.startswith("p227_") for x in names) or eval_counts != eval_want or \
            len(tester.forward.seen) != keys or len(tester.forward.graphs) != keys or \
            not all(np.isfinite([r["lsd"], r["snr"], r["rtf"]]).all() for r in tester.rows):
        raise AssertionError(f"raw eval: want {RAW_UTTERANCES} p227 clips of one length, "
                             f"launches {eval_want}, finite metrics; got {names}, {segs}, "
                             f"{eval_counts}")
    print(f"raw corpus phase in {time.perf_counter() - t0:.1f} s  [{smi}]")
    report = dict(library=native.library_path().name, write_s=write_s,
                  flac_bytes=flac_bytes, decode_s=decode_s, degrade=degrade, pipelines=pipes,
                  conversion=timed, train=timing, eval_rows=tester.rows,
                  launches=dict(train=train_counts, eval=eval_counts))
    return report, train_counts


VARIANT_YAMLS = {"single": "vm_asr_48k_MPD_SINGLE.yaml", "p2m": "vm_asr_48k_MPD_P2M.yaml",
                 "m2p": "vm_asr_48k_MPD_M2P.yaml"}
# The other generator options, each on the flagship config: MODEL options
# set away from the flagship's.
VARIANT_OPTIONS = {
    "MambaUNet (VM_ASR_BASIC)": {"MODEL.NAME": "VM_ASR_BASIC"},
    "latent dims (16, 32, 64, 128, 256)": {"MODEL.VSSM.DIMS": [16, 32, 64, 128, 256]},
    "head v2": {"MODEL.VSSM.OUTPUT": "v2"},
    "head v1": {"MODEL.VSSM.OUTPUT": "v1"},
    "patch embed v1": {"MODEL.VSSM.PATCHEMBED": "v1"},
    "GMLP": {"MODEL.VSSM.GMLP": True},
    "FUSE_STREAMS": {"MODEL.VSSM.FUSE_STREAMS": True},
    # N = 2: every SS2D takes the general-N route, two recurrences a scan.
    "d_state 2": {"MODEL.VSSM.SSM_D_STATE": 2},
}
LATENT = "latent dims (16, 32, 64, 128, 256)"
FUSE = "FUSE_STREAMS"
# The FUSE_STREAMS GAN step's batch (its decoder scans at 16 rows) and its
# warm-up and timed steps.
FUSE_BATCH = 8
FUSE_WARMUP, FUSE_TIMED = 3, 5
# The widest flagship forward checked: the fused kernels at their longest
# chunks (256 steps at L = 16384, K·D = 128; 16 at batch 1).
WIDE_BATCH = 32


def variant_config(yaml_name: str, amp: bool, gan: bool = False, overrides=None):
    """A shipped config loaded from its YAML (PyYAML required), with the
    overrides of ``flagship_config`` and ``overrides`` ({dotted key: value};
    a list DIMS cannot come through ``--opts``, whose values take the type
    of the default)."""
    overrides = overrides or {}
    c = load_config(str(ROOT / "configs" / yaml_name), [
        "TRAIN.ADVERSARIAL.ENABLE", str(gan), "AMP_ENABLE", str(amp), "OUTPUT",
        str(OUT / "logs"), "TAG", "16000_48000", "INFERENCE.RESULTS_DIR",
        str(OUT / "results")]).defrost()
    for key, value in overrides.items():
        *path, leaf = key.split(".")
        node = c
        for part in path:
            node = node[part]
        node[leaf] = value
    c.freeze()
    v = c.MODEL.VSSM
    dims = 16 if "MODEL.VSSM.DIMS" in overrides else v.DIMS
    got = (dims, list(v.DEPTHS), c.DATA.STFT.N_FFT, c.DATA.STFT.HOP_LENGTH, c.DATA.TARGET_SR,
           c.DTYPE.COMPUTE)
    if got != (16, [2, 2, 2, 2], 1024, 240, 48000, "bfloat16"):
        raise AssertionError(f"{yaml_name}: not the flagship's widths: {got}")
    return c


def scan_launches(model, grad: bool = True) -> dict:
    """Scan launches of one forward of ``model``, derived from its SS2Ds and
    the routing of ops/scan_api.py (the fused kernel where N = 1 and
    K·D ≥ 128; the N-state kernel where N = 16 and, as ``grad`` says, no
    gradient is needed; else one recurrence launch per state channel) and
    from how often each stage runs: once, but the shared mag decoder twice
    where the phase stream goes through it unfused (concat skips, no
    phase-decoder fix, no FUSE_STREAMS). The N-state count is there only
    for a model that has such a scan."""
    shared = getattr(model, "core_phase", None) is not None \
        and not model.phase_decoders_used and not model.fuse_streams
    out = Counter(selective_scan_fused=0, linear_recurrence=0)
    for name, child in model.named_children():
        calls = 2 if shared and name == "layers_decoder_mag" else 1
        for m in child.modules():
            if not isinstance(m, SS2D):
                continue
            if m.d_state == 1 and K * m.d_inner >= 128:
                out["selective_scan_fused"] += calls
            elif m.d_state == NSTATE_N and not grad:
                out["selective_scan_nstate"] += calls
            else:
                out["linear_recurrence"] += calls * m.d_state
    return dict(out)


def variant_forward(label, cfg32, cfg16, smi, batch: int = 1):
    """``batch`` flagship segments through the variant in fp32 with the
    kernels and with the plain scan (TF32 off), with the exact launches of
    the kernels' forward; then the bf16 forward's wall time (CUDA events) and
    device busy time (torch.profiler)."""
    model = get_generator(cfg32, "cuda")
    want = scan_launches(model, grad=False)
    seg = int(cfg32.DATA.SEGMENT * cfg32.DATA.TARGET_SR)
    x = torch.from_numpy(np.stack([speech_like(seg / 48000, 48000, seed=3 + i)
                                   for i in range(batch)])[:, None]).cuda()
    hf = torch.full((batch,), 171, device="cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        zero_counts()
        y_kernel = model(x, hf)
        torch.cuda.synchronize()
        got = read_counts()
        set_scan_impl(model, "plain")
        y_plain = model(x, hf)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    rel = ((y_kernel - y_plain).abs().max() / y_plain.abs().max()).item()
    finite = bool(torch.isfinite(y_kernel).all())
    want_all = dict(want, selective_scan_fused_bwd=0, linear_recurrence_reverse=0)
    model16 = get_generator(cfg16, "cuda")
    model16.load_state_dict(model.state_dict())
    del model, y_kernel, y_plain
    fwd = lambda: model16(x, hf)  # noqa: E731
    with torch.inference_mode():
        wall = cuda_ms(fwd, reps=5, per=1)
        events = device_kernels(fwd)
    busy = busy_us(events) / 1e3 if events else None
    row = dict(variant=label, batch=batch, launches=got, want=want_all, rel_err=rel,
               tol=MODEL_REL_TOL, finite=finite,
               params=sum(p.numel() for p in model16.parameters()),
               bf16_wall_ms=wall, bf16_device_busy_ms=busy, device_events=len(events))
    print(f"{label}: {row['params']} parameters; fp32 max|kernel - plain| / max|plain| "
          f"{rel:.3e} (tol {MODEL_REL_TOL}), finite {finite}; launches per forward {got} "
          f"(derived {want}); bf16 batch-{batch} forward {wall:.2f} ms wall (CUDA events), "
          f"device busy {fmt_ms(busy)} in {len(events)} events  [{smi}]")
    if not finite or not rel <= MODEL_REL_TOL or got != want_all:
        raise AssertionError(f"variant {label} failed: {row}")
    return row, want


def checkpoint_memory_check(smi):
    """A SINGLE-config generator step (loss and gradient, batch 4, DropPath
    on) with and without MODEL.VSSM.USE_CHECKPOINT, from one seed and batch:
    in fp32 (TF32 off) the gradients within the train-gradient bar of each
    other; in bf16, the config's compute dtype, within BF16_CKPT_BARS of it
    (printed beside the gap of two runs without the checkpoint). In both the
    scans' forward
    launches no more often with the checkpoint (its policy keeps their
    outputs), and the peak memory of each run."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    report = {}
    for amp in (False, True):
        # fp32 in full fp32 (TF32 off), bf16 with the process's settings.
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
            tf32 if amp else (False, False)
        runs, batch = {}, None
        for ckpt in (False, True, "again"):
            cfg = variant_config(VARIANT_YAMLS["single"], amp=amp, gan=True,
                                 overrides={"MODEL.VSSM.USE_CHECKPOINT": ckpt is True})
            model = get_generator(cfg, "cuda")
            step = make_train_step(cfg, model, get_discriminators(cfg, "cuda"))
            if batch is None:
                batch = train_batch(cfg, seeds=range(40, 40 + TRAIN_BATCH))
            for _ in range(2):  # the first pass warms cuDNN and the allocator
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                zero_counts()
                total, _, _ = step.gen_loss_fn(batch["wave_input"], batch["wave_target"],
                                               batch["highcut"],
                                               torch.Generator(device="cuda").manual_seed(7))
                grads = torch.autograd.grad(total, list(model.parameters()),
                                            allow_unused=True, materialize_grads=True)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                counts = read_counts()
            runs[ckpt] = dict(grads=grads, peak_gb=peak / 1e9, launches=counts,
                              loss=total.item())
            names = [n for n, _ in model.named_parameters()]
            del model, step, total
        top = max(g.abs().max().item() for g in runs[False]["grads"])

        def gap(a, b):
            r = [((x - y).abs().max() / (GRAD_REL * y.abs().max() + GRAD_FLOOR * top)).item()
                 for x, y in zip(a, b)]
            i = int(np.argmax(r))
            return r[i], names[i]

        worst, worst_name = gap(runs[True]["grads"], runs[False]["grads"])
        noise, noise_name = gap(runs["again"]["grads"], runs[False]["grads"])
        dtype = "bf16" if amp else "fp32, TF32 off"
        print(f"USE_CHECKPOINT, {dtype}: loss {runs[True]['loss']:.6f} vs "
              f"{runs[False]['loss']:.6f} without; gradients apart by {worst:.3e} of the bar "
              f"({GRAD_REL} of each tensor's scale + {GRAD_FLOOR} of the largest; "
              f"{worst_name}), two runs without it {noise:.3e} ({noise_name}); launches "
              f"{runs[True]['launches']} vs {runs[False]['launches']} without; peak memory above "
              f"the weights {runs[True]['peak_gb']:.3f} GB vs {runs[False]['peak_gb']:.3f} GB "
              f"without (torch.cuda.max_memory_allocated, batch {TRAIN_BATCH})  [{smi}]")
        report[dtype] = dict(grad_ratio=worst, grad_ratio_tensor=worst_name, rerun_ratio=noise,
                             peak_gb={str(k): v["peak_gb"] for k, v in runs.items()},
                             launches={str(k): v["launches"] for k, v in runs.items()},
                             loss={str(k): v["loss"] for k, v in runs.items()})
        # The fp32 run is the gate at 1.0 of the bar. bf16 gradients differ
        # from run to run by more than that bar (the backward's atomics): the
        # bf16 gap has a fixed limit of BF16_CKPT_BARS, which a recompute that
        # drew other masks or lost a scan output, moving a gradient by O(1)
        # of its scale (~300 bars), still breaks.
        limit = BF16_CKPT_BARS if amp else 1.0
        if not worst <= limit or runs[True]["launches"] != runs[False]["launches"]:
            raise AssertionError(f"USE_CHECKPOINT changed the step ({dtype})")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return report


def single_cli_phase(smi, per_fwd):
    """configs/vm_asr_48k_MPD_SINGLE.yaml through vm_asr_tpu_torch.cli,
    in-process: train one epoch (4 steps at batch 4, one validation batch,
    step 2 profiled) with checkpoints, --eval of the best checkpoint on two
    two-segment clips, --inference on one one-segment clip; exact launch
    counts for each from ``per_fwd``, the launches of one forward."""
    cfg_path = str(ROOT / "configs" / VARIANT_YAMLS["single"])
    work = OUT / "cli_single"
    runs = ROOT / "build" / "chip_smoke_cli_single"
    for d in (work, runs):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    run_dir = runs / "DualStreamInteractiveMambaUNet" / "chip"
    f, r = per_fwd["selective_scan_fused"], per_fwd["linear_recurrence"]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        zero_counts()
        mode, trainer = cli.run(["--cfg", cfg_path, "--tag", "chip", "--input_sr", "16000",
                                 "--synthetic_data", "--synthetic_n", "20", "--opts",
                                 "TRAIN.EPOCHS", "1", "PROFILE_STEPS", "1", "DATA.VALID_SPLIT",
                                 "0.2", "DATA.NUM_WORKERS", "4", "TENSORBOARD.ENABLE", "False",
                                 "OUTPUT", str(runs)])
        train_counts = read_counts()
        first = trainer.timings[-1]
        n, v = first["steps"], len(trainer.valid_loader)
        want = dict(selective_scan_fused=f * (n + v), selective_scan_fused_bwd=f * n,
                    linear_recurrence=r * (n + v), linear_recurrence_reverse=r * n)
        files = sorted(p.name for p in run_dir.glob("checkpoint-*.pth"))
        steps = first["step_s"]
        prof = first["profile"]
        warm_ms = 1e3 * statistics.median(steps[2:])
        busy = prof["device_busy_ms"]
        idle = None if busy is None else 1 - busy / warm_ms
        print(f"SINGLE cli train: mode {mode}, {n} steps, {v} validation batch(es), launches "
              f"{train_counts} (derived {want}), checkpoints {files}; s/it "
              f"{[round(s, 4) for s in steps]} (host clock; step 1 cold, step 2 profiled), "
              f"{warm_ms / 1e3:.4f} median over steps 3..{n}; profiled step device busy "
              f"{fmt_ms(busy)} in {prof['device_events']} events, idle share "
              f"{'not measured' if idle is None else f'{idle:.3f}'} of the median unprofiled "
              f"step; epoch {first['epoch_s']:.3f} s, validation {first['valid_s']:.3f} s, "
              f"checkpoint writes {first['save_ms']:.1f} ms  [{smi}]")
        if (mode, n, v) != ("train", 4, 1) or train_counts != want or files != [
                f"checkpoint-{k}-{m}.pth" for k in ("best", "latest") for m in ("G", "mpd")] \
                or not all(train_counts.values()):
            raise AssertionError(f"SINGLE cli train: want 4 steps, 1 validation batch, "
                                 f"launches {want}; got {n}, {v}, {train_counts}, {files}")
        del trainer

        zero_counts()
        mode, tester = cli.run(["--cfg", cfg_path, "--eval", "--tag", "16000_48000", "--resume",
                                str(run_dir), "--synthetic_data", "--synthetic_n", "2", "--opts",
                                "TENSORBOARD.ENABLE", "False", "TEST.RESULTS_DIR",
                                str(work / "results")])
        eval_counts = read_counts()
        shapes = {tester._num_segments(row["samples"]) for row in tester.rows}
        # One signature (bucket 2): its eager first call and its capture.
        eval_want = forward_counts(2, f, r)
        for row in tester.rows:
            print(f"SINGLE cli eval {row['name']}: rtf {row['rtf']:.4f}, rtf_compute "
                  f"{row['rtf_compute']:.4f}, snr {row['snr']:.3f}, lsd {row['lsd']:.3f} "
                  f"(lsd_input {row['lsd_input']:.3f})  [{smi}]")
        print(f"SINGLE cli eval: {len(tester.rows)} clips of {shapes} segments, launches "
              f"{eval_counts} (derived {eval_want})")
        if mode != "eval" or len(tester.rows) != 2 or shapes != {2} or eval_counts != eval_want \
                or issued_forwards(tester.forward) != 2 \
                or not all(np.isfinite(row["lsd"]) for row in tester.rows):
            raise AssertionError(f"SINGLE cli eval: want 2 two-segment clips and launches "
                                 f"{eval_want}; got {shapes}, {eval_counts}")

        clip = work / "clip_16k.wav"
        save_wav(str(clip), speech_like(2.555, 16000, seed=50), 16000)
        zero_counts()
        mode, inferencer = cli.run(["--cfg", cfg_path, "--inference", "--tag", "16000_48000",
                                    "--resume", str(run_dir), "--input", str(clip), "--opts",
                                    "INFERENCE.RESULTS_DIR", str(work / "inference")])
        infer_counts = read_counts()
        infer_want = dict(selective_scan_fused=f, selective_scan_fused_bwd=0,
                          linear_recurrence=r, linear_recurrence_reverse=0)
        wavs = sorted(p.name for p in (work / "inference").rglob("*.wav"))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inferencer.infer_file(str(clip), quiet=True)
        torch.cuda.synchronize()
        rtf = (time.perf_counter() - t) / 2.555
        print(f"SINGLE cli inference: mode {mode}, launches {infer_counts} (derived "
              f"{infer_want}), wrote {wavs}; a second infer_file of the 2.555 s clip: RTF "
              f"{rtf:.4f} (host clock, synchronised)  [{smi}]")
        if mode != "inference" or infer_counts != infer_want or not wavs \
                or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"SINGLE cli inference: launches {infer_counts}, wavs {wavs}")
    finally:
        os.chdir(cwd)
    return dict(train=first, launches=dict(train=train_counts, eval=eval_counts,
                                           inference=infer_counts),
                idle_share=idle, warm_step_s=warm_ms / 1e3, eval_rows=tester.rows,
                inference_rtf=rtf), train_counts


def fuse_streams_step(smi):
    """The flagship GAN train step (MPD, AdamW) with FUSE_STREAMS at batch
    FUSE_BATCH, bf16: FUSE_WARMUP warm-up and FUSE_TIMED timed steps (CUDA
    events) with the launches derived from its SS2Ds, finite losses, every
    parameter whose first-step gradient exceeds AdamW's eps changed, and
    the peak memory."""
    cfg = variant_config(CONFIG.name, amp=True, gan=True, overrides={
        **VARIANT_OPTIONS[FUSE], "DATA.BATCH_SIZE": FUSE_BATCH})
    g = gan_steps(cfg, 90, 2, FUSE_WARMUP, FUSE_TIMED, batch=FUSE_BATCH)
    per_fwd = scan_launches(g.model)
    want = dict(per_fwd, selective_scan_fused_bwd=per_fwd["selective_scan_fused"],
                linear_recurrence_reverse=per_fwd["linear_recurrence"])
    row = dict(batch=FUSE_BATCH, dtype="bfloat16", median_ms=g.median_ms, step_ms=g.step_ms,
               x_real_time=FUSE_BATCH * cfg.DATA.SEGMENT / (g.median_ms / 1e3),
               peak_memory_gb=g.peak_gb, launches_per_step=g.per_step, want=want,
               finite=g.finite, changed=g.changed, tensors=g.tensors,
               unchanged_first_grad=g.unchanged, first=g.values[0], last=g.values[-1])
    print(f"{FUSE} GAN step, batch {FUSE_BATCH}, bf16: {FUSE_TIMED} steps after "
          f"{FUSE_WARMUP}: median {g.median_ms:.2f} ms/step (CUDA events; min "
          f"{min(g.step_ms):.2f}, max {max(g.step_ms):.2f}), peak memory {g.peak_gb:.2f} GB; "
          f"launches per step {g.per_step} (derived {want}); finite {g.finite}; parameters "
          f"changed {g.changed} of {g.tensors} tensors; unchanged, with the first step's "
          f"max|grad| (AdamW eps {g.eps}): {g.unchanged}  [{smi}]")
    if not g.finite or g.per_step != want or g.stuck:
        raise AssertionError(f"{FUSE} step failed; unchanged with a gradient: {g.stuck}")
    return row


def variants_phase(smi):
    """The variants phase: each shipped stream-interaction config and each
    other generator option, kernels against plain with exact launches; the
    SINGLE config through the CLI; the latent layout's and FUSE_STREAMS's
    gradients; the FUSE_STREAMS GAN step at batch 8; the flagship at batch
    32; and USE_CHECKPOINT. Returns (report, the SINGLE training run's
    launches)."""
    rows = []
    per_fwd = {}
    for name, yaml_name in VARIANT_YAMLS.items():
        row, per_fwd[name] = variant_forward(
            f"{yaml_name} ({name})", variant_config(yaml_name, amp=False),
            variant_config(yaml_name, amp=True), smi)
        rows.append(row)
    # A single stream runs half the flagship's scans: 15 fused, 2 recurrence.
    half = dict(selective_scan_fused=sum(FUSED_CALLS.values()) // 2,
                linear_recurrence=sum(LR_CALLS.values()) // 2)
    if per_fwd["single"] != half:
        raise AssertionError(f"SINGLE's launches per forward {per_fwd['single']} != {half}")
    cli_report, single_launches = single_cli_phase(smi, per_fwd["single"])
    for label, overrides in VARIANT_OPTIONS.items():
        row, per_fwd[label] = variant_forward(
            label, variant_config(CONFIG.name, amp=False, overrides=overrides),
            variant_config(CONFIG.name, amp=True, overrides=overrides), smi)
        rows.append(row)
    rows.append(variant_forward(f"flagship at batch {WIDE_BATCH}", variant_config(
        CONFIG.name, amp=False), variant_config(CONFIG.name, amp=True), smi,
        batch=WIDE_BATCH)[0])
    print(f"fp32 generator gradient of the {LATENT} layout (the fused backward at D = 512 "
          f"in its bottleneck), kernels and plain scan vs the plain scan in fp64:")
    cfg32 = variant_config(CONFIG.name, amp=False, gan=True, overrides={
        **VARIANT_OPTIONS[LATENT], "MODEL.VSSM.DROP_PATH_RATE": 0.0})
    f, r = per_fwd[LATENT]["selective_scan_fused"], per_fwd[LATENT]["linear_recurrence"]
    # Here the plain fp32 scan's own rounding reaches the bar (1.05 of it on
    # output_layer_phase.3.bias, a bias whose gradient sums 262 144
    # positions; the kernels 0.29, on an H100): the kernels are held to the
    # fp64 witness and to the plain fp32 scan.
    latent_grad = gradient_check(cfg32, dict(selective_scan_fused=f, selective_scan_fused_bwd=f,
                                             linear_recurrence=r, linear_recurrence_reverse=r),
                                 plain_to_witness=False)
    print(f"fp32 generator gradient with {FUSE} (the shared mag decoder's scans, forward "
          f"and backward, at 2B rows), kernels and plain scan vs the plain scan in fp64:")
    cfg32 = variant_config(CONFIG.name, amp=False, gan=True, overrides={
        **VARIANT_OPTIONS[FUSE], "MODEL.VSSM.DROP_PATH_RATE": 0.0})
    f, r = per_fwd[FUSE]["selective_scan_fused"], per_fwd[FUSE]["linear_recurrence"]
    fuse_grad = gradient_check(cfg32, dict(selective_scan_fused=f, selective_scan_fused_bwd=f,
                                           linear_recurrence=r, linear_recurrence_reverse=r))
    return dict(forwards=rows, single_cli=cli_report, latent_grad=latent_grad,
                fuse_streams_grad=fuse_grad, fuse_streams_step=fuse_streams_step(smi),
                use_checkpoint=checkpoint_memory_check(smi)), single_launches


def gradient_check(cfg32, want, plain_to_witness: bool = True):
    """The fp32 generator loss of ``cfg32`` (batch 1) differentiated with the
    kernels, with the plain scan, with the kernels again and with the plain
    scan in fp64, the witness the kernels are held to (GRAD_REL of each
    tensor's scale + GRAD_FLOOR of the largest), and with them the plain fp32
    scan (``plain_to_witness``) or, where that scan's own rounding is the
    larger, the kernels again against it; fails unless the kernels' launches
    are ``want``, every SS2D parameter gets a gradient and the plain routes
    launch nothing. TF32 off."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    print(f"loss {totals['kernel']:.6f} (plain scan {totals['plain']:.6f}, fp64 "
          f"{totals['plain64']:.6f}); {len(named)} tensors; bar {GRAD_REL} of each tensor's "
          f"scale + {GRAD_FLOOR} of the largest ({top:.3e}); worst of the bar from the fp64 "
          f"witness: kernels {worst:.3e} ({worst_name}, scale {worst_scale:.3e}), plain fp32 "
          f"{plain_worst:.3e} ({plain_name}); kernels vs plain fp32 {apart:.3e} ({apart_name}); "
          f"the kernels run twice {noise:.3e} ({noise_name}); zero SS2D gradients {zero}; "
          f"kernel launches {counts['kernel']}; TF32 off")
    second = plain_worst if plain_to_witness else apart
    if worst > 1 or second > 1 or zero or counts["kernel"] != want \
            or any(counts["plain"].values()) or any(counts["plain64"].values()):
        raise AssertionError("train gradient check failed")
    return dict(
        worst_ratio=worst, worst_tensor=worst_name, worst_scale=worst_scale,
        plain_worst_ratio=plain_worst, plain_worst_tensor=plain_name,
        kernel_vs_plain_ratio=apart, rerun_ratio=noise, rel=GRAD_REL, floor=GRAD_FLOOR,
        top=top, furthest=[(named[i][0], kernel_r[i][1], plain_r[i][1]) for i in order[:6]],
        loss_kernel=totals["kernel"], loss_plain=totals["plain"],
        loss_fp64=totals["plain64"], launches=counts["kernel"])


# The stacked generator's scan calls a forward: one per pair of SS2Ds, at
# (2B, L, K·D) with two parameter sets. (L, K·D) → calls.
STACKED_FUSED_CALLS = {shape: n // 2 for shape, n in FUSED_CALLS.items()}
STACKED_LR_CALLS = {shape: n // 2 for shape, n in LR_CALLS.items()}
STACKED_FORWARD = dict(selective_scan_fused=15, selective_scan_fused_bwd=0, linear_recurrence=2,
                       linear_recurrence_reverse=0)
# functorch's warning when an op under vmap has no batching rule and runs
# once per stream: the stacking would be silently undone.
PER_STREAM_LOOP = "There is a performance drop"
# A GAN option's first fp32 step against the flagship MPD step's from the
# same weights, relative (the JAX package's bar, tests/test_stacked_mpd.py).
OPTION_LOSS_REL = 5e-4
# The flagship GAN step with each option on, TRAIN.ADVERSARIAL overrides,
# and the metrics its first step shares with the MPD step's.
SHARED = ("generator/multi_resolution_stft", "generator/features_mpd")
MPD_TERMS = SHARED + ("generator/adversarial_mpd", "discriminator/mpd", "total_disc_loss",
                      "total_loss")
GAN_OPTIONS = {
    "mpd + msd": ({"DISCRIMINATORS": ["mpd", "msd"]},
                  SHARED + ("generator/adversarial_mpd", "discriminator/mpd")),
    "stacked mpd, one group": ({"MPD_STACKED": True}, MPD_TERMS),
    "stacked mpd, [[2,3],[5,7,11]]": ({"MPD_STACKED": True,
                                       "MPD_STACK_GROUPS": [[2, 3], [5, 7, 11]]}, MPD_TERMS),
    "wgan-gp": ({"GAN_LOSS_TYPE": "wgan-gp"}, SHARED),
}


def stacked_config(amp: bool, gan: bool = False, adversarial=None):
    """The flagship config with MODEL.VSSM.STACKED_EXECUTION (and
    TRAIN.ADVERSARIAL overrides)."""
    c = flagship_config(amp, gan).defrost()
    c.MODEL.VSSM.STACKED_EXECUTION = True
    for key, value in (adversarial or {}).items():
        c.TRAIN.ADVERSARIAL[key] = value
    c.freeze()
    return c


def check_fused_groups(batch, l, kd, dtype, gen):
    """The forward kernel over (2·batch, L, K·D) rows with two parameter
    sets, rows 0..batch−1 reading the first and the rest the second, as the
    stacked generator calls it: y and H0 against the plain version with the
    same sets, and a second call and a call on a capped grid against the
    first, bit for bit."""
    (u, dts, bs, cs, a, bias, dsk, k), _ = fused_inputs(2 * batch, l, kd, dtype, gen)
    a2, bias2, _ = init_ranges(kd, gen)
    args = (u, dts, bs, cs, torch.stack([a, 0.5 * a2]), torch.stack([bias, bias2]),
            torch.stack([dsk, -0.5 * dsk]), k)
    y, h0, chunk = selective_scan_fused_fwd(*args)
    runs = [(y, h0), selective_scan_fused_fwd(*args)[:2],
            selective_scan_fused_fwd(*args, max_ctas=CAPPED_CTAS)[:2]]
    torch.cuda.synchronize()
    name = f"fused, two parameter sets, {(2 * batch, l, kd)} {dtype}"
    check_same(name, *runs)
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    err = check_close(name, y, selective_scan_fused_plain(*args), tol)
    h0_err = check_close(f"{name} H0", h0, fused_chunk_states_plain(*args, chunk), FP32_TOL)
    # The second set must be the one rows batch.. read: against one set alone.
    one = selective_scan_fused_plain(*(t[batch:] for t in args[:4]), a2 * 0.5, bias2,
                                     -0.5 * dsk, k)
    check_close(f"{name} second set", y[batch:], one, tol)
    size = u.element_size()
    nbytes = (3 * 2 * batch * l * kd + 2 * 2 * batch * l * K) * size + 2 * 3 * kd * 4 \
        + h0.numel() * 4
    bms, by = bound_ms(nbytes, FUSED_OPS * 2 * batch * l * kd)
    fn = lambda: selective_scan_fused_fwd(*args)  # noqa: E731
    dev, _ = device_split(fn, FWD_KERNELS)
    return dict(kernel="selective_scan_fused", sets=2, shape=[2 * batch, l, kd],
                dtype=str(dtype), chunk=chunk, max_abs_err=err, tol=tol, h0_max_abs_err=h0_err,
                bytes=nbytes, ms=cuda_ms(fn, reps=3, per=10), device_ms=dev,
                plain_ms=cuda_ms(lambda: selective_scan_fused_plain(*args), reps=3, per=2),
                bound_ms=bms, bound_by=by)


def host_ms(fn, reps: int = 5) -> float:
    """Median host ms to issue one call of ``fn`` (the host's clock until it
    returns, the device idle and waited for before each call)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def serve_pair(models, fwd_of, rounds: int = 2):
    """Wall (CUDA events), host ms to issue it, device busy ms, device
    events and idle share of one batch-1 forward of each model, taken in
    turns (a, b, b, a, ...)."""
    out = {name: [] for name in models}
    for r in range(rounds):
        for name in (list(models) if r % 2 == 0 else list(models)[::-1]):
            fwd = fwd_of(models[name])
            wall = cuda_ms(fwd, reps=5, per=1)
            issue = host_ms(fwd)
            events = device_kernels(fwd)
            busy = busy_us(events) / 1e3 if events else None
            out[name].append(dict(wall_ms=wall, host_issue_ms=issue, device_busy_ms=busy,
                                  device_events=len(events),
                                  idle_share=None if busy is None else 1 - busy / wall))
    return out


def first_fp32_step(overrides):
    """The metrics of one fp32 flagship GAN step (TF32 off) with
    TRAIN.ADVERSARIAL ``overrides``, from the seeded weights and DropPath
    draws every option shares."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = stacked_config(amp=False, gan=True, adversarial=overrides)
    model, discs = get_generator(cfg, "cuda"), get_discriminators(cfg, "cuda")
    states = (GenState(model, make_optimizer(cfg, 1000, model)),
              {n: DiscState(d, make_optimizer(cfg, 1000, d)) for n, d in discs.items()})
    batch = train_batch(cfg, seeds=range(30, 30 + TRAIN_BATCH))
    metrics = make_train_step(cfg, model, discs)(
        *states, batch, torch.Generator(device="cuda").manual_seed(cfg.SEED))[2]
    out = {k: float(v) for k, v in metrics.items()}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


def gan_option_step(label, overrides):
    """The flagship GAN step (bf16, batch 4) with TRAIN.ADVERSARIAL
    ``overrides``, as the train phase times the MPD step: 3 warm-up and 10
    timed steps (CUDA events) with the scans' launches counted over the 10,
    the peak memory, and one profiled step."""
    cfg = stacked_config(amp=True, gan=True, adversarial=overrides)
    model, discs = get_generator(cfg, "cuda"), get_discriminators(cfg, "cuda")
    gen_state = GenState(model, make_optimizer(cfg, 1000, model))
    disc_states = {n: DiscState(d, make_optimizer(cfg, 1000, d)) for n, d in discs.items()}
    step = make_train_step(cfg, model, discs)
    batches = [train_batch(cfg, seeds=range(30 + TRAIN_BATCH * i, 30 + TRAIN_BATCH * (i + 1)))
               for i in range(4)]
    rng = torch.Generator(device="cuda").manual_seed(cfg.SEED)
    run = lambda i: step(gen_state, disc_states, batches[i % len(batches)], rng)  # noqa: E731
    for i in range(3):
        run(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    marks, history = [], []
    for i in range(10):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        history.append(run(3 + i)[2])
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [s_.elapsed_time(e_) for s_, e_ in marks]
    finite = all(np.isfinite(float(v)) for m in history for v in m.values())
    events = device_kernels(lambda: run(0))
    busy = busy_us(events) / 1e3 if events else None
    median_ms = statistics.median(step_ms)
    return dict(option=label, overrides=overrides,
                disc_types={n: type(d).__name__ for n, d in discs.items()}, median_ms=median_ms,
                step_ms=step_ms, device_busy_ms=busy, device_events=len(events),
                idle_share=None if busy is None else 1 - busy / median_ms, peak_memory_gb=peak_gb,
                launches=launches, finite=finite,
                last_metrics={k: float(v) for k, v in history[-1].items()})


def gan_steps(cfg, seed0: int, n_batches: int, warmup: int, timed: int,
              batch: int = TRAIN_BATCH):
    """The GAN train step of ``cfg`` on the card from seeded weights:
    ``warmup`` steps, then ``timed`` steps by CUDA events with the scans'
    launches counted over them; ``n_batches`` batches of ``batch`` segments
    of synthetic speech (seeds from ``seed0``) in turn. Returns a namespace with the models,
    ``run(i)`` (one more step on batch i), the step times, the
    metrics, the peak memory and the parameters left unchanged with their
    first step's gradient: a tensor may stay unchanged only if that
    gradient is below AdamW's eps (``stuck`` lists those that may not)."""
    model, discs = get_generator(cfg, "cuda"), get_discriminators(cfg, "cuda")
    gen_state = GenState(model, make_optimizer(cfg, 1000, model))
    disc_states = {n: DiscState(d, make_optimizer(cfg, 1000, d)) for n, d in discs.items()}
    step = make_train_step(cfg, model, discs)
    batches = [train_batch(cfg, seeds=range(seed0 + batch * i, seed0 + batch * (i + 1)))
               for i in range(n_batches)]
    rng = torch.Generator(device="cuda").manual_seed(cfg.SEED)
    params = list(model.named_parameters()) + [
        (f"{n}.{k}", t) for n, d in discs.items() for k, t in d.named_parameters()]
    before = {n: t.detach().clone() for n, t in params}
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
    for i in range(warmup):  # cuDNN autotuning, allocator
        run(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    marks, history = [], []
    for i in range(timed):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        history.append(run(warmup + i)[2])
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    launches = read_counts()
    if layer_norm.launches:  # autograd records the step's LayerNorms: torch's route
        raise AssertionError(f"{layer_norm.launches} LayerNorm kernel launches in "
                             f"{timed} GAN train steps")
    step_ms = [s_.elapsed_time(e_) for s_, e_ in marks]
    values = [{k: float(v) for k, v in m.items()} for m in history]
    changed = {n for n, t in params if not torch.equal(before[n], t)}
    # Any gradient above eps moves a tensor by about lr (≥ MIN_LR = 1e-5
    # here) on the first step, more than half an ulp of any |parameter| < 8;
    # below it the update lr·m/(sqrt(v) + eps) rounds away.
    eps = cfg.TRAIN.OPTIMIZER.EPS
    unchanged = {n: first_grad.get(n) for n in sorted(set(before) - changed)}
    return SimpleNamespace(
        model=model, discs=discs, run=run, step_ms=step_ms, median_ms=statistics.median(step_ms), values=values,
        finite=all(np.isfinite(v) for m in values for v in m.values()), launches=launches,
        per_step={k: n / timed for k, n in launches.items()},
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, eps=eps, tensors=len(before),
        changed=len(changed), unchanged=unchanged,
        stuck=[n for n, g in unchanged.items() if g is None or not g < eps])


DIMS24_YAML = "vm_asr_48k_16k_MPD_VSSM24.yaml"
DIMS24_WARMUP, DIMS24_TIMED = 3, 5


def dims24_step(smi):
    """The dims-24 config's GAN train step (configs/vm_asr_48k_16k_MPD_VSSM24
    .yaml: D = 48 at stage 0, K·D 192 to 1536 through the fused kernels) at
    batch 4, bf16: DIMS24_WARMUP warm-up and DIMS24_TIMED timed steps (CUDA
    events) with the launches derived from its SS2Ds, finite losses, every
    parameter whose first-step gradient exceeds AdamW's eps changed, the
    peak memory and one profiled step's busy time."""
    cfg = load_config(str(ROOT / "configs" / DIMS24_YAML), [
        "AMP_ENABLE", "True", "DATA.BATCH_SIZE", str(TRAIN_BATCH), "OUTPUT", str(OUT / "logs")])
    v = cfg.MODEL.VSSM
    got = (v.DIMS, list(v.DEPTHS), cfg.DATA.STFT.N_FFT, cfg.DATA.TARGET_SR, cfg.DTYPE.COMPUTE,
           list(cfg.TRAIN.ADVERSARIAL.DISCRIMINATORS))
    if got != (24, [2, 2, 2, 2], 1024, 48000, "bfloat16", ["mpd"]):
        raise AssertionError(f"{DIMS24_YAML}: {got}")
    g = gan_steps(cfg, 60, 2, DIMS24_WARMUP, DIMS24_TIMED)
    per_fwd = scan_launches(g.model)
    want = dict(per_fwd, selective_scan_fused_bwd=per_fwd["selective_scan_fused"],
                linear_recurrence_reverse=per_fwd["linear_recurrence"])
    events = device_kernels(lambda: g.run(0))
    busy = busy_us(events) / 1e3 if events else None
    median_ms, step_ms, per_step = g.median_ms, g.step_ms, g.per_step
    row = dict(config=DIMS24_YAML, batch=TRAIN_BATCH, dtype="bfloat16",
               params=sum(p.numel() for p in g.model.parameters()), median_ms=median_ms,
               step_ms=step_ms, x_real_time=TRAIN_BATCH * cfg.DATA.SEGMENT / (median_ms / 1e3),
               device_busy_ms=busy, device_events=len(events),
               idle_share=None if busy is None else 1 - busy / median_ms,
               peak_memory_gb=g.peak_gb, launches_per_step=per_step, want=want,
               finite=g.finite, changed=g.changed, tensors=g.tensors,
               unchanged_first_grad=g.unchanged, first=g.values[0], last=g.values[-1])
    idle = "not measured" if busy is None else f"{row['idle_share']:.3f}"
    print(f"dims 24 ({DIMS24_YAML}, {row['params']} generator parameters), batch "
          f"{TRAIN_BATCH}, bf16: {DIMS24_TIMED} steps after {DIMS24_WARMUP}: median "
          f"{median_ms:.2f} ms/step (CUDA events; min {min(step_ms):.2f}, max "
          f"{max(step_ms):.2f}), device busy {fmt_ms(busy)} in {len(events)} events, idle "
          f"share {idle}, peak "
          f"memory {g.peak_gb:.2f} GB; launches per step {per_step} (derived {want}); finite "
          f"{g.finite}; parameters changed {g.changed} of {g.tensors} tensors; unchanged, "
          f"with the first step's max|grad| (AdamW eps {g.eps}): {g.unchanged}  [{smi}]")
    print(f"dims 24 first step {json.dumps(g.values[0])}")
    if not g.finite or per_step != want or g.stuck:
        raise AssertionError(f"dims-24 step failed; unchanged with a gradient: {g.stuck}")
    return row


def stacked_phase(smi, cli_throughput, mpd_step):
    """Stacked execution and the remaining adversarial options on the card
    (phase 11 of the module docstring), beside the unstacked CLI throughput
    and the train phase's flagship MPD step (``mpd_step``) of the same run.
    Returns the report, with a summary of the stacked path's launches and
    times for the kernels line."""
    report = {}
    gen = torch.Generator().manual_seed(1)
    checks = []
    for batch in (1, 8):
        for (l, kd) in FUSED_CALLS:
            for dtype in (torch.bfloat16, torch.float32):
                checks.append(check_fused_groups(batch, l, kd, dtype, gen))
        for (l, d) in LR_CALLS:  # the kernels phase showed one call to be one kernel
            checks.append(check_lr(2 * batch, l, d, gen, one_call=False))
    for c in checks:
        extra = f"; H0 max|err| {c['h0_max_abs_err']:.3e}" if "h0_max_abs_err" in c else ""
        print(f"{c['kernel']}{' (2 parameter sets)' if c.get('sets') else ''} "
              f"{tuple(c['shape'])} {c['dtype'][6:]}: max|err| {c['max_abs_err']:.3e} (tol "
              f"{c['tol']}){extra}; kernel {c['ms']:.4f} ms (device {fmt_ms(c['device_ms'])}), "
              f"plain {c['plain_ms']:.3f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']}); "
              f"bitwise repeatable, also on {CAPPED_CTAS} CTAs  [{smi}]")
    report["kernel_checks"] = checks

    # The stacked flagship forward in fp32 against the unstacked one.
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg32 = stacked_config(amp=False)
    model = get_generator(cfg32, "cuda")
    stacked = to_stacked(cfg32, model)
    if not isinstance(stacked, DualStreamStackedMambaUNet):
        raise AssertionError(f"to_stacked gave {type(stacked).__name__}")
    seg = int(cfg32.DATA.SEGMENT * cfg32.DATA.TARGET_SR)
    x = torch.from_numpy(speech_like(seg / 48000, 48000, seed=4)[None, None]).cuda()
    hf = torch.tensor([171], device="cuda")
    with torch.inference_mode(), warnings.catch_warnings():
        warnings.filterwarnings("error", message=PER_STREAM_LOOP)
        zero_counts()
        y_st = stacked(x, hf)
        torch.cuda.synchronize()
        got = read_counts()
        y_un = model(x, hf)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    rel = ((y_st - y_un).abs().max() / y_un.abs().max()).item()
    finite = bool(torch.isfinite(y_st).all())
    print(f"stacked flagship forward, fp32 (TF32 off): max|stacked - unstacked| / "
          f"max|unstacked| {rel:.3e} (tol {MODEL_REL_TOL}), finite {finite}; launches {got} "
          f"(want {STACKED_FORWARD}; unstacked 30 + 4)  [{smi}]")
    if not finite or not rel <= MODEL_REL_TOL or got != STACKED_FORWARD:
        raise AssertionError("stacked forward check failed")
    # bf16, the config's compute dtype: each model's distance from the fp32
    # forward, the yardstick for the stacked-vs-unstacked gap in bf16 (the
    # vmapped linears add their bias after rounding, grouped convs sum in
    # another order).
    cfg = stacked_config(amp=True)
    model16 = get_generator(cfg, "cuda")
    model16.load_state_dict(model.state_dict())
    stacked16 = to_stacked(cfg, model16)
    with torch.inference_mode():
        y16 = {"unstacked": model16(x, hf), "stacked": stacked16(x, hf)}
    bf16_gap = {k: ((v - y_un).abs().max() / y_un.abs().max()).item() for k, v in y16.items()}
    bf16_gap["stacked vs unstacked"] = ((y16["stacked"] - y16["unstacked"]).abs().max()
                                        / y16["unstacked"].abs().max()).item()
    print(f"bf16 flagship forward, max|diff| / max|fp32 unstacked|: "
          f"{ {k: f'{v:.3e}' for k, v in bf16_gap.items()} }  [{smi}]")
    report["model_check"] = dict(rel_err=rel, tol=MODEL_REL_TOL, launches=got,
                                 bf16_rel=bf16_gap)
    del model, stacked, stacked16, y_st, y_un, y16

    # Serve, bf16: the Inferencer with the stacked model and the unstacked one.
    model = model16
    servers = {"unstacked": Inferencer(cfg, model, output_dir=str(OUT / "results_unstacked"),
                                       device="cuda"),
               "stacked": Inferencer(cfg, to_stacked(cfg, model),
                                     output_dir=str(OUT / "results_stacked"), device="cuda")}
    clips = {"short_1.2s": 1.2, "one_segment_2.555s": 2.555, "long_7.5s": 7.5}
    paths = {name: str(OUT / f"{name}.wav") for name in clips}  # written by the serve phase
    seg = servers["stacked"].num_frames_per_seg

    def serve(inf, name):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inf.infer_file(paths[name], quiet=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    rows, served = [], Counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=PER_STREAM_LOOP)
        for name, sec in clips.items():
            cold = {k: serve(inf, name)[1] for k, inf in servers.items()}
            n_in = int(round(sec * 48000))
            n_pad = seg if n_in <= seg else -(-n_in // seg) * seg
            n_seg = num_segments(n_pad, seg, cfg.INFERENCE.OVERLAP) if n_pad > seg else 1
            n_fwd = sum(segment_bucket_counts(n_seg).values())
            walls, outs = {k: [] for k in servers}, {}
            for order in (("unstacked", "stacked"), ("stacked", "unstacked")):
                for k in order:
                    outs[k], wall = serve(servers[k], name)
                    walls[k].append(wall)
            for k, inf in servers.items():
                # Counted on the device: the forwards replay CUDA graphs.
                want = forward_counts(n_fwd, *((15, 2) if k == "stacked" else (30, 4)))
                counts = device_scan_calls(lambda inf=inf: serve(inf, name), want)
                if counts != want:
                    raise AssertionError(f"serve {name} ({k}): scan calls on the device "
                                         f"{counts}, want {want}")
                if k == "stacked":
                    served.update(counts)
            diff = ((outs["stacked"] - outs["unstacked"]).abs().max()
                    / outs["unstacked"].abs().max()).item()
            r = dict(name=name, audio_s=sec, forwards=n_fwd, cold_wall_s=cold,
                     wall_s={k: statistics.median(v) for k, v in walls.items()},
                     rtf={k: statistics.median(v) / sec for k, v in walls.items()},
                     rel_diff_bf16=diff, finite=bool(torch.isfinite(outs["stacked"]).all()))
            print(f"serve {name}: RTF stacked {r['rtf']['stacked']:.4f}, unstacked "
                  f"{r['rtf']['unstacked']:.4f} (host clock, synchronised, median of 2 in turns; "
                  f"set-up {cold['stacked']:.3f} / {cold['unstacked']:.3f} s); {n_fwd} forward(s) "
                  f"of 15 + 2 and 30 + 4 launches; bf16 outputs apart by {diff:.2e} of their "
                  f"scale  [{smi}]")
            if not r["finite"]:
                raise AssertionError(f"serve {name}: stacked output not finite")
            rows.append(r)
    report["serve"] = rows

    # Batch-1 forward, bf16: device events, busy and idle, in turns.
    x = torch.from_numpy(speech_like(seg / 48000, 48000, seed=2)[None, None]).cuda()
    hf = torch.tensor([171], device="cuda")
    prof = serve_pair({k: inf for k, inf in servers.items()},
                      lambda inf: (lambda: inf.forward(x, hf)))
    for k, runs in prof.items():
        for p_ in runs:
            idle = "not measured" if p_["idle_share"] is None else f"{p_['idle_share']:.3f}"
            print(f"batch-1 forward, {k}: wall {p_['wall_ms']:.2f} ms (CUDA events), host "
                  f"{p_['host_issue_ms']:.2f} ms to issue it, device busy "
                  f"{fmt_ms(p_['device_busy_ms'])} in {p_['device_events']} device events, "
                  f"idle share {idle}  [{smi}]")
    report["profile"] = prof
    del servers, model

    # The CLI with the option on: --eval of the cli phase's best checkpoint,
    # --inference of one clip, --throughput at batch 4.
    work = OUT / "cli_stacked"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    run_dir = ROOT / "build" / "chip_smoke_cli" / "DualStreamInteractiveMambaUNet" / "chip"
    on = ["MODEL.VSSM.STACKED_EXECUTION", "True", "TENSORBOARD.ENABLE", "False"]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=PER_STREAM_LOOP)
            zero_counts()
            mode, tester = cli.run(["--cfg", str(CONFIG), "--eval", "--tag", "16000_48000",
                                    "--resume", str(run_dir), "--synthetic_data", "--synthetic_n",
                                    "4", "--opts", "TEST.RESULTS_DIR", str(work / "results"),
                                    *on])
            eval_counts = read_counts()
            # One signature (bucket 2): its eager first call and its capture.
            want = forward_counts(2, 15, 2)
            for r in tester.rows:
                print(f"stacked cli eval {r['name']}: rtf {r['rtf']:.4f}, rtf_compute "
                      f"{r['rtf_compute']:.4f}, snr {r['snr']:.3f}, lsd {r['lsd']:.3f}  [{smi}]")
            if mode != "eval" or not isinstance(tester.generator, DualStreamStackedMambaUNet) \
                    or eval_counts != want or issued_forwards(tester.forward) != 2 or \
                    len(tester.rows) != 4 or \
                    not all(np.isfinite([r["lsd"], r["snr"]]).all() for r in tester.rows):
                raise AssertionError(f"stacked cli eval: launches {eval_counts} (want {want})")
            eval_rows = tester.rows
            del tester

            clip = work / "clip_16k.wav"
            save_wav(str(clip), speech_like(2.555, 16000, seed=51), 16000)
            zero_counts()
            mode, inferencer = cli.run(["--cfg", str(CONFIG), "--inference", "--tag",
                                        "16000_48000", "--resume", str(run_dir), "--input",
                                        str(clip), "--opts", "INFERENCE.RESULTS_DIR",
                                        str(work / "inference"), *on])
            infer_counts = read_counts()
            wavs = sorted(p.name for p in (work / "inference").rglob("*.wav"))
            if mode != "inference" or infer_counts != STACKED_FORWARD or not wavs or \
                    not isinstance(inferencer.generator, DualStreamStackedMambaUNet):
                raise AssertionError(f"stacked cli inference: launches {infer_counts}, {wavs}")
            print(f"stacked cli inference: launches {infer_counts}, wrote {wavs}  [{smi}]")
            del inferencer

            zero_counts()
            mode, stats = cli.run(["--cfg", str(CONFIG), "--throughput", "--batch_size", "4",
                                   "--opts", "OUTPUT", str(work / "logs"), *on])
            tp_counts = read_counts()
    finally:
        os.chdir(cwd)
    calls = 1 + 2 + 3 * 3 * 10  # of one signature: its eager first call and its capture
    print(f"stacked cli throughput: {stats['segments_per_second']:.2f} segments/s at batch "
          f"{stats['batch']} ({stats['seconds_per_call'] * 1e3:.2f} ms a call, CUDA events); "
          f"unstacked in the cli phase {cli_throughput:.2f}; launches {tp_counts}  [{smi}]")
    if mode != "throughput" or tp_counts != forward_counts(2, 15, 2):
        raise AssertionError(f"stacked cli throughput: launches {tp_counts} for {calls} calls "
                             f"of one signature (want {forward_counts(2, 15, 2)})")
    report["cli"] = dict(eval_rows=eval_rows, eval_launches=eval_counts,
                         inference_launches=infer_counts, throughput=stats,
                         throughput_launches=tp_counts, unstacked_throughput=cli_throughput)

    # The GAN step with each remaining adversarial option, beside the train
    # phase's MPD step: its first fp32 step's losses against the MPD step's
    # from the same weights, then its bf16 timing.
    base = first_fp32_step({})
    per_step = dict(selective_scan_fused=30, selective_scan_fused_bwd=30, linear_recurrence=4,
                    linear_recurrence_reverse=4)
    rows = []
    # The MPD step again first, timed here beside the options: host-clock
    # step times drift over a run (PERF.md), device busy time does not.
    for label, (overrides, keys) in {"mpd (flagship), again": ({}, ()),
                                     **GAN_OPTIONS}.items():
        first = first_fp32_step(overrides) if overrides else base
        gaps = {k: abs(first[k] - base[k]) / abs(base[k]) for k in keys}
        row = dict(gan_option_step(label, overrides), first_fp32_metrics=first,
                   loss_rel_to_mpd_step=gaps)
        idle = "not measured" if row["idle_share"] is None else f"{row['idle_share']:.3f}"
        print(f"GAN step, {label} ({row['disc_types']}): {row['median_ms']:.2f} ms/step median "
              f"(CUDA events, 10 steps after 3; the flagship MPD step {mpd_step['median_ms']:.2f} "
              f"in the train phase, busy {fmt_ms(mpd_step['device_busy_ms'])}, peak "
              f"{mpd_step['peak_memory_gb']:.2f} GB), device busy {fmt_ms(row['device_busy_ms'])} "
              f"in {row['device_events']} events, idle share {idle}, peak memory "
              f"{row['peak_memory_gb']:.2f} GB; launches {row['launches']} in 10 steps; first "
              f"fp32 step's losses against the MPD step's: "
              f"{ {k: f'{v:.2e}' for k, v in gaps.items()} } (bar {OPTION_LOSS_REL})  [{smi}]")
        if not row["finite"] or any(not v <= OPTION_LOSS_REL for v in gaps.values()) or \
                {k: v / 10 for k, v in row["launches"].items()} != per_step:
            raise AssertionError(f"GAN option {label} failed: {row}")
        rows.append(row)
    report["gan_options"] = rows

    def per_forward(name, calls, key):
        """One stacked batch-1 forward's sum of ``key`` over its calls (bf16
        fused forward, fp32 recurrence)."""
        dtype = "torch.bfloat16" if name == "selective_scan_fused" else "torch.float32"
        by = {tuple(c["shape"][1:]): c for c in checks if c["kernel"] == name
              and c["shape"][0] == 2 and c["dtype"] == dtype}
        vals = [by[s_][key] for s_ in calls]
        return None if None in vals else sum(n * by[s_][key] for s_, n in calls.items())

    summary = {name: dict(
        stacked_serve_launches=served[name],
        gan_option_launches={r["option"]: r["launches"][name] for r in rows},
        stacked_forward_device_ms=per_forward(name, calls, "device_ms"),
        stacked_forward_bound_ms=per_forward(name, calls, "bound_ms"),
        stacked_max_abs_err=max(c["max_abs_err"] for c in checks if c["kernel"] == name))
        for name, calls in (("selective_scan_fused", STACKED_FUSED_CALLS),
                            ("linear_recurrence", STACKED_LR_CALLS))}
    for name in ("selective_scan_fused_bwd", "linear_recurrence_reverse"):
        summary[name] = dict(gan_option_launches={r["option"]: r["launches"][name]
                                                  for r in rows})
    for name, s_ in summary.items():
        print(f"{name}, stacked path: {s_}")
    report["summary"] = summary
    return report



# ------------------------------------------------------------ look-back contention
# A kernel that holds all but HOLD_FREE_SMS of the card's SMs (one CTA per SM:
# the most shared memory a block may take, so nothing else fits beside it)
# for HOLD_MS by %globaltimer, and a one-CTA kernel that waits until every
# holding CTA has started. Plain C interface, built by nvcc beside the port's
# kernels.
HOLD_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__global__ void hold_kernel(unsigned long long ns, unsigned* started) {
  extern __shared__ unsigned char smem[];
  if (threadIdx.x == 0) atomicAdd(started, 1u);
  const uint64_t t0 = now_ns();
  while (now_ns() - t0 < ns) {
    if (threadIdx.x == 0) smem[0] = 1;
    __nanosleep(1000);
  }
}
__global__ void wait_kernel(const unsigned* started, unsigned n) {
  while (atomicAdd((unsigned*)started, 0u) < n) __nanosleep(1000);
}
extern "C" int vmasr_hold_sms(int ctas, long long ns, unsigned* started, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(hold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  hold_kernel<<<ctas, 1024, smem, (cudaStream_t)stream>>>((unsigned long long)ns, started);
  return (int)cudaGetLastError();
}
extern "C" int vmasr_wait_started(unsigned* started, unsigned n, void* stream) {
  wait_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(started, n);
  return (int)cudaGetLastError();
}
"""
HOLD_MS = 200.0
HOLD_FREE_SMS = 4
HOLD_SMEM = 232448  # a block's largest dynamic shared memory on an H100


def hold_build_start():
    """Start nvcc on HOLD_SOURCE (beside the kernels' builds); returns
    (process or None when built already, library path)."""
    from vm_asr_tpu_torch.ops.build import BUILD_ROOT, NVCC_FLAGS, nvcc_path

    src = BUILD_ROOT / "chip_smoke_hold.cu"
    lib = BUILD_ROOT / "chip_smoke_hold.so"
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    if lib.exists() and src.exists() and src.read_text() == HOLD_SOURCE:
        return None, lib
    src.write_text(HOLD_SOURCE)
    return subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def contention_check(name, call, ref):
    """The scan ``call()`` (returning its output tensor) on a stream of its
    own while the hold kernel holds all but HOLD_FREE_SMS SMs on another for
    HOLD_MS: the scan's CTAs that find no room wait to be resident, and the
    look-back must not wait on them. (Both are side streams: the legacy
    default stream would wait for the hold to end first.) The scan kernel
    must end before the hold does, by CUDA events from the hold's start, and
    its output must equal ``ref`` bit for bit."""
    import ctypes

    lib = ctypes.CDLL(str(HOLD_LIB[0]))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = sms - HOLD_FREE_SMS
    started = torch.zeros(1, dtype=torch.int32, device="cuda")
    side, mine = torch.cuda.Stream(), torch.cuda.Stream()
    # First launches load a kernel's module, which waits for the device: make
    # them now, and the scan's look-back workspace on its stream.
    with torch.cuda.stream(mine):
        err = lib.vmasr_hold_sms(1, ctypes.c_longlong(0), ctypes.c_void_p(started.data_ptr()),
                                 HOLD_SMEM, ctypes.c_void_p(mine.cuda_stream)) or \
            lib.vmasr_wait_started(ctypes.c_void_p(started.data_ptr()), 0,
                                   ctypes.c_void_p(mine.cuda_stream))
        call()
    started.zero_()
    torch.cuda.synchronize()
    t0, hold_end, scan_start, scan_end = (torch.cuda.Event(enable_timing=True) for _ in range(4))
    with torch.cuda.stream(side):
        t0.record()
        err = err or lib.vmasr_hold_sms(ctas, ctypes.c_longlong(int(HOLD_MS * 1e6)),
                                        ctypes.c_void_p(started.data_ptr()), HOLD_SMEM,
                                        ctypes.c_void_p(side.cuda_stream))
        hold_end.record()
    with torch.cuda.stream(mine):
        err = err or lib.vmasr_wait_started(ctypes.c_void_p(started.data_ptr()), ctas,
                                            ctypes.c_void_p(mine.cuda_stream))
        if err:
            raise RuntimeError(f"{name}: the hold kernels did not launch (cudaError {err})")
        scan_start.record()
        out = call()
        scan_end.record()
    torch.cuda.synchronize()
    hold_ms, start_ms, end_ms = (t0.elapsed_time(e) for e in (hold_end, scan_start, scan_end))
    same = torch.equal(out, ref)
    print(f"{name}: while {ctas} of {sms} SMs were held for {hold_ms:.1f} ms, the scan ran from "
          f"{start_ms:.2f} to {end_ms:.2f} ms ({end_ms - start_ms:.3f} ms on the other "
          f"{HOLD_FREE_SMS}); bitwise equal to the uncontended run: {same}")
    if not end_ms < hold_ms or not same:
        raise AssertionError(f"{name}: the scan did not finish while another kernel held the "
                             "card's SMs, or its output changed")
    return dict(scan=name, held_sms=ctas, sms=sms, hold_ms=hold_ms, scan_start_ms=start_ms,
                scan_end_ms=end_ms, contended_ms=end_ms - start_ms)


HOLD_LIB = [None]


def lookback_contention(gen):
    """The fused forward and the recurrence (forward and reverse) at
    main-path shapes, each under contention_check, against their own
    uncontended output."""
    args, _ = fused_inputs(TRAIN_BATCH, 16384, 128, torch.bfloat16, gen)
    out = [contention_check("fused forward (4, 16384, 128) bf16",
                            lambda: selective_scan_fused_fwd(*args)[0],
                            selective_scan_fused_fwd(*args)[0])]
    a, b, h, grad = lr_inputs(TRAIN_BATCH, 65536, 64, gen, 1_000_003)
    out.append(contention_check("recurrence forward (4, 65536, 64) fp32",
                                lambda: linear_recurrence_fwd(a, b), linear_recurrence_fwd(a, b)))
    out.append(contention_check("recurrence reverse (4, 65536, 64) fp32",
                                lambda: linear_recurrence_reverse(a, h, grad)[0],
                                linear_recurrence_reverse(a, h, grad)[0]))
    return out


EPOCHS = 1 << 30  # the look-back's epochs are 1 .. EPOCHS - 1 (csrc/scan_common.cuh)
GRAPH_REPLAYS = 3


def graph_replays(name, call, make_inputs):
    """``call`` captured in a CUDA graph on a side stream (after one eager
    call there, which makes the stream's look-back workspace) and replayed
    GRAPH_REPLAYS times, fresh inputs (``make_inputs(i)``) copied into the
    static ones before each replay: each replay's outputs equal, bit for
    bit, the eager call's on the same inputs on the current stream. Returns
    the replays checked."""
    static = make_inputs(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = call(*static)
    for i in range(1, GRAPH_REPLAYS + 1):
        fresh = make_inputs(i)
        for t, f in zip(static, fresh):
            t.copy_(f)
        graph.replay()
        got = [o.clone() for o in out]
        want = call(*fresh)
        torch.cuda.synchronize()
        check_same(f"{name}: replay {i} against the eager call", want, got)
    return GRAPH_REPLAYS


def graphed_forward_check(inferencer):
    """The Inferencer's forward (one CUDA graph per bucket, train/steps.py:
    GraphedForward) at buckets 1, 2, 4 and 8: its first call (eager on the
    capture stream), second (the capture's replay) and third, each bitwise
    the generator's eager forward on the current stream; then two bucket-8
    replays on other inputs whose outputs are read only after both ran; and
    dsp.istft bitwise torch.istft at the forward's spectra."""
    model, seg = inferencer.generator, inferencer.num_frames_per_seg
    rows = []
    for b in (1, 2, 4, 8):
        x = torch.from_numpy(np.stack([speech_like(seg / 48000, 48000, seed=20 + b + i)[None]
                                       for i in range(b)])).cuda()
        hf = torch.full((b,), 170, dtype=torch.int64, device="cuda")
        with torch.inference_mode():
            want = model(x, hf)
        got = [inferencer.forward(x, hf) for _ in range(3)]
        torch.cuda.synchronize()
        check_same(f"graphed forward, bucket {b}", (want,), *[(g,) for g in got])
        rows.append(dict(bucket=b, calls=3, bitwise=True))
    xs = [torch.from_numpy(np.stack([speech_like(seg / 48000, 48000, seed=40 + 8 * k + i)[None]
                                     for i in range(8)])).cuda() for k in range(2)]
    hf = torch.full((8,), 170, dtype=torch.int64, device="cuda")
    replays = [inferencer.forward(x, hf) for x in xs]
    with torch.inference_mode():
        wants = [model(x, hf) for x in xs]
    torch.cuda.synchronize()
    check_same("two bucket-8 replays read after both ran", wants, replays)
    spec = torch.polar(torch.rand(4, 513, 512, device="cuda") + 0.1,
                       torch.rand(4, 513, 512, device="cuda") * 6.28 - 3.14)
    window = hann_window(1024, "cuda")
    check_same("dsp.istft against torch.istft", (istft(spec, 1024, 240, 1024),),
               (torch.istft(spec, n_fft=1024, hop_length=240, win_length=1024, window=window,
                            center=True, normalized=True, onesided=True),))
    print(f"graphed forward: buckets 1, 2, 4, 8, three calls each, and two bucket-8 replays "
          f"read after both ran, each bitwise the eager forward; dsp.istft bitwise torch.istft")
    return rows


SPINS = 8  # kernels that open each profiled call of replay_vs_eager


def replay_vs_eager(inferencer, x, hf, tries: int = 3):
    """A profiled replay's device kernels against a profiled eager forward's
    on the same inputs: the same kernels by name, apart from the replay's
    copies (its inputs in, its output out), and busy times within 5 %, so
    that the benchmark's device-trace metrics see the graph's kernels.
    Copies and memsets (Memcpy, Memset: a graph's memset reads "Unknown")
    are left out of the names. Each profiled call starts with SPINS short
    spin kernels and a synchronize, left out too: the profiler may drop a
    capture's first device events (up to four, on an H100, in a process
    that had profiled the earlier phases). A pair whose names differ is
    taken again (at most ``tries`` pairs)."""
    def profiled(fn):
        def call():
            for _ in range(SPINS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            return fn()
        return [e for e in device_kernels(call) if "spin_kernel" not in e[0]]

    def eager():
        with torch.inference_mode():
            return inferencer.generator(x, hf)

    for _ in range(tries):
        replay_events = profiled(lambda: inferencer.forward(x, hf))
        eager_events = profiled(eager)
        names = [Counter(n for n, _, _ in ev if not n.startswith(("Memcpy", "Memset")))
                 for ev in (replay_events, eager_events)]
        extra, missing = names[0] - names[1], names[1] - names[0]
        busy = [busy_us(ev) / 1e3 for ev in (replay_events, eager_events)]
        row = dict(replay_busy_ms=busy[0], eager_busy_ms=busy[1],
                   replay_events=len(replay_events), eager_events=len(eager_events),
                   replay_only=dict(extra), eager_only=dict(missing))
        print(f"profiled replay: {len(replay_events)} device events, busy {busy[0]:.3f} ms; "
              f"eager forward {len(eager_events)}, busy {busy[1]:.3f} ms; kernels only in the "
              f"replay {dict(extra)}, only in the eager forward {dict(missing)}")
        if not missing and not extra:
            break
        seqs = [[n for n, _, _ in ev if not n.startswith(("Memcpy", "Memset"))]
                for ev in (replay_events, eager_events)]
        at = next((i for i, (a, b) in enumerate(zip(*seqs)) if a != b), min(map(len, seqs)))
        for side, seq in zip(("replay", "eager"), seqs):
            print(f"  {side} from its kernel {at - 2} of {len(seq)}: "
                  f"{[n[:70] for n in seq[max(at - 2, 0):at + 3]]}")
    if missing or extra or not abs(busy[0] - busy[1]) <= 0.05 * busy[1]:
        raise AssertionError(f"replay against eager: {row}")
    return row


def epoch_wrap(name, call, inputs):
    """The look-back's epoch on the device across its wrap: a call on a
    stream whose workspace's epoch word holds EPOCHS - 2 runs at the last
    epoch and must give the bits of the call before it and leave the
    workspace zeroed; the next call (epoch 1) gives them again."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = call(*inputs)
        ws = lookback._workspaces[(torch.device("cuda", torch.cuda.current_device()),
                                   side.cuda_stream)]
        ws.view(torch.int64)[0] = EPOCHS - 2
        last = call(*inputs)
        zeroed = int(ws.count_nonzero())
        after = call(*inputs)
        epoch = int(ws.view(torch.int64)[0])
    torch.cuda.synchronize()
    check_same(f"{name}: calls across the epoch's wrap", first, last, after)
    if zeroed or epoch != 1:
        raise AssertionError(f"{name}: {zeroed} bytes of the workspace left after the call at "
                             f"the last epoch, epoch word {epoch} after the next (want 0, 1)")


def graph_checks(gen):
    """The one-launch scans (fused forward, recurrence forward and reverse)
    in CUDA graphs (graph_replays) at main-path shapes, and across the
    epoch's wrap (epoch_wrap), also on a capped grid."""
    rows = []

    def fused_call(*t, max_ctas=0):
        return selective_scan_fused_fwd(*t, K, max_ctas=max_ctas)[:2]

    for batch, l, kd, dtype in ((1, 16384, 128, torch.bfloat16), (8, 256, 1024, torch.bfloat16),
                                (TRAIN_BATCH, 4096, 256, torch.float32)):
        name = f"fused forward {(batch, l, kd)} {str(dtype)[6:]}"
        base = fused_inputs(batch, l, kd, dtype, gen)[0][:7]
        # Fresh inputs: u, dts, B and C rolled along L.
        make = lambda i, base=base: tuple(t.roll(7 * i, 1) if t.dim() == 3 else t  # noqa: E731
                                          for t in base)
        rows.append(dict(call=name, replays=graph_replays(name, fused_call, make)))
        epoch_wrap(name, fused_call, make(0))
        epoch_wrap(f"{name} on {CAPPED_CTAS} CTAs",
                   lambda *t: fused_call(*t, max_ctas=CAPPED_CTAS), make(0))
    for r, l, d in ((1, 65536, 64), (8, 262144, 8)):
        name = f"recurrence forward {(r, l, d)}"
        make = lambda i, a=(r, l, d): lr_inputs(*a, gen, 1_000_003 + i)[:2]  # noqa: E731
        call = lambda a, b, max_ctas=0: (linear_recurrence_fwd(a, b, max_ctas=max_ctas),)  # noqa: E731
        rows.append(dict(call=name, replays=graph_replays(name, call, make)))
        epoch_wrap(name, call, make(0))
        epoch_wrap(f"{name} on {CAPPED_CTAS} CTAs",
                   lambda a, b: call(a, b, max_ctas=CAPPED_CTAS), make(0))
    for r, l, d in ((TRAIN_BATCH, 65536, 64), (TRAIN_BATCH, 262144, 8)):
        name = f"recurrence reverse {(r, l, d)}"
        make = lambda i, a=(r, l, d): tuple(  # noqa: E731
            lr_inputs(*a, gen, 1_000_033 + i)[j] for j in (0, 2, 3))
        call = lambda a, h, g, max_ctas=0: linear_recurrence_reverse(  # noqa: E731
            a, h, g, max_ctas=max_ctas)
        rows.append(dict(call=name, replays=graph_replays(name, call, make)))
        epoch_wrap(name, call, make(0))
        epoch_wrap(f"{name} on {CAPPED_CTAS} CTAs",
                   lambda a, h, g: call(a, h, g, max_ctas=CAPPED_CTAS), make(0))
    for row in rows:
        print(f"{row['call']}: {row['replays']} graph replays with fresh inputs, each bitwise "
              f"its eager call; bitwise across the epoch's wrap (also on {CAPPED_CTAS} CTAs), "
              f"the workspace zeroed by the call at the last epoch")
    return rows


# ------------------------------------------------------------------ parallel
# Two ranks on cuda:0 over gloo (NCCL takes one rank a card, and the script
# needs one card), then NCCL at world size 1.
#
# The input: the flagship task's, speech at 48 kHz with nothing above 8 kHz
# (a 16 kHz input brought to 48 kHz). A rank runs the step on 2 rows, the
# one process on 4. cuFFT rounds other batch sizes differently, and the
# generator turns that into O(1) where a bin's phase sits near ±π (angle()
# flips) and where log2 takes the empty band's rounding: the port's STFT
# takes each signal on its own on the card (dsp/stft.py), and batch_rows
# measures, in every run, how far the same rows' output moves between batch
# 2 and batch 4 (it was 17 % of the output's largest value before).
#
# The rows' batch dependence gates too: within PAR_ROWS_BAR, about 5× its
# reading on an H100 (5.7e-5); with one batched transform of every signal
# it read 0.17, so a return to that fails the run.
#
# The controls, both read every run: "permuted", the one-process step on
# the batch's rows in reverse order (only the order of the batch's sums
# changes), and "batch 8", the one-process step on the 4 rows twice over
# (the same loss and gradient, other shapes for every op, as a rank's 2
# rows are). PAR_CONTROL's readings gate: batch 8. The permuted control
# leaves every op's shape and so every row's rounding as it was, while a
# rank's ops run at 2 rows and round otherwise (batch_rows). On an H100 it
# moved a cancelling generator leaf (a dt_projs weight or bias of the first
# encoder stage) by ~3e-6 of its scale, where dp2 moved it by 1.6e-2 and
# batch 8 by at least half that (dp2 read ≤ 2.2× batch 8 on every leaf).
# Bars, each floored at
# PAR_LOSS_REL of the value (losses) or fp32's epsilon of a leaf's scale
# (gradients):
# - dp2 against one process at the same global batch: each first-step loss,
#   and each gradient leaf's max |diff|, within PAR_CONTROL_X times the
#   control's;
# - chained steps and the resume: each step's losses within PAR_CONTROL_X
#   times the control chain's, and the generator's parameters after within
#   PAR_PARAM_LR of one step (lr) of the one process's;
# - dp1 × mp2: the forward within 1e-5 of the unsplit one (max |diff| / max
#   |ref|), the gradients within tests/test_mp.py:78-79's rtol 2e-4, atol
#   2e-5, the two ranks' forwards bitwise alike and their gradients within
#   those bars of each other (the card's backward reductions run in no fixed
#   order; the train step averages them over the mp group);
# - the sequence-sharded scan: fp32 IO within tests/test_seq_scan.py's 2e-4
#   and its gradients within 2e-3; bf16 IO, each element within its
#   roundings: a shard's scan rounds its zero-state y_local to bf16 before
#   the carried-in state's correction is added, as in the JAX package, and
#   rounds the sum again, and the one-device kernel rounds once; half a
#   bf16 ulp is at most 2^-8 of a value, so |y − ref| ≤ 2^-8·|y_local| +
#   2^-7·|ref|, plus the fp32 bar for the rest.
PAR_DIR = ROOT / "build" / "chip_smoke_parallel"
PAR_RANKS = 2
PAR_LOSS_REL = 1e-5
PAR_CONTROL_X = 5.0
PAR_CONTROL = "batch 8"
PAR_ROWS_BAR = 3e-4
PAR_CHAIN, PAR_PARAM_LR = 3, 0.5
PAR_TIMED = 3
MP_FWD_REL = 1e-5
MP_GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
SEQ_SHAPE = (TRAIN_BATCH, 16384, 128)
SEQ_TOL, SEQ_GRAD_TOL = dict(rtol=2e-4, atol=2e-4), dict(rtol=2e-3, atol=2e-3)
LOSS_KEYS = ("total_loss", "generator/multi_resolution_stft", "generator/adversarial_mpd",
             "generator/features_mpd", "discriminator/mpd")


def batch_rows(cfg):
    """max |rows 0-1 at batch 2 − the same rows at batch 4| / max |batch 4|
    of the generator's fp32 eval forward (one process)."""
    gen = get_generator(cfg, "cuda").eval()
    b = train_batch(cfg, seeds=range(50, 54))
    with torch.no_grad():
        y4 = gen(b["wave_input"], b["highcut"])
        y2 = gen(b["wave_input"][:2], b["highcut"][:2])
    return float((y2 - y4[:2]).abs().max() / y4.abs().max())


def parallel_config():
    """The flagship GAN config in fp32, DropPath off (the control permutes
    the batch's rows, and a mask follows its row)."""
    cfg = flagship_config(amp=False, gan=True).defrost()
    cfg.MODEL.VSSM.DROP_PATH_RATE = 0.0
    cfg.freeze()
    return cfg


def par_build(cfg, init):
    """The flagship generator and MPD on the card with the weights ``init``,
    and their fresh train states."""
    from vm_asr_tpu_torch.models import get_discriminators as discs_of

    gen, discs = get_generator(cfg, "cuda"), discs_of(cfg, "cuda")
    gen.load_state_dict(init["generator"])
    for n, d in discs.items():
        d.load_state_dict(init[n])
    return (gen, discs, GenState(gen, make_optimizer(cfg, 1000, gen)),
            {n: DiscState(d, make_optimizer(cfg, 1000, d)) for n, d in discs.items()})


def record_first_gradients(state, name, into):
    """Have ``state``'s optimizer copy the first gradients it takes (the
    step's, averaged over dp) to the host, as ``into[name]``."""
    apply = state.optimizer.apply

    def recording(grads):
        grads = list(grads)
        into[name] = [g.detach().float().cpu() for g in grads]
        state.optimizer.apply = apply
        return apply(grads)

    state.optimizer.apply = recording


def par_chain(cfg, init, batches, mesh=None, ckpt_dir=None, timed=0):
    """PAR_CHAIN + 1 flagship GAN steps (fp32) from ``init`` on ``batches``
    (global batches on the host); with a dp ``mesh``, this rank's rows.
    After PAR_CHAIN steps the states go to ``ckpt_dir`` (rank 0 writes) and
    every rank restores them into models built anew, which take the last
    step. Returns each step's losses, the first step's gradients by model
    (on the host) and the generator's parameters after, and with ``timed``
    the ms of that many more steps (CUDA events, after a barrier each)."""
    from vm_asr_tpu_torch.core.checkpoint import CheckpointManager
    from vm_asr_tpu_torch.parallel import shard_batch

    first = {}

    def build():
        gen, discs, gs, ds = par_build(cfg, init)
        if not first:  # the models of the first step
            for name, state in (("generator", gs), *ds.items()):
                record_first_gradients(state, name, first)
        return gen, gs, ds, make_train_step(cfg, gen, discs, mesh=mesh)

    gen, gs, ds, step = build()
    rng = torch.Generator(device="cuda").manual_seed(cfg.SEED)
    losses = []

    def one(i, b):
        db = {k: v.cuda() for k, v in b.items()}
        if mesh is not None:
            db = shard_batch(db, mesh)
        return step(gs, ds, db, rng)[2]

    for i, b in enumerate(batches[:PAR_CHAIN + 1] if ckpt_dir else batches[:1]):
        if ckpt_dir and i == PAR_CHAIN:
            ckpt = CheckpointManager(str(ckpt_dir))
            ckpt.save("G", gs, 0, 0.0)
            for n, s in ds.items():
                ckpt.save(n, s, 0, 0.0)
            ckpt.barrier()
            gen, gs, ds, step = build()
            for tag, s in [("G", gs), *ds.items()]:
                ckpt.restore("G" if tag == "G" else tag, "latest", target=s)
        m = one(i, b)
        losses.append({k: float(m[k]) for k in LOSS_KEYS})
    times = []
    for i in range(timed):
        if torch.distributed.is_initialized():
            torch.distributed.barrier()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        one(i, batches[i % len(batches)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return dict(losses=losses, grads=first, step_ms=times,
                names={"generator": [n for n, _ in gen.named_parameters()]},
                gen_after={k: v.cpu() for k, v in gen.state_dict().items()})


def par_mp(cfg, init, mesh=None):
    """The fp32 generator's forward on two segments and the gradients of
    mean((out − y)²), with the K directions split over ``mesh``'s mp axis
    when given, and the scans' launches of the forward."""
    from vm_asr_tpu_torch.parallel import set_activation_mesh

    gen = par_build(cfg, init)[0]
    batch = train_batch(cfg, seeds=(40, 41))
    set_activation_mesh(mesh)
    try:
        zero_counts()
        with torch.no_grad():
            gen.eval()
            out = gen(batch["wave_input"], batch["highcut"])
        launches = read_counts()
        gen.train()
        out_t = gen(batch["wave_input"], batch["highcut"], generator=torch.Generator("cuda"))
        loss = (out_t - batch["wave_target"]).square().mean()
        grads = torch.autograd.grad(loss, list(gen.parameters()))
    finally:
        set_activation_mesh(None)
    return dict(out=out.cpu(), grads=[g.cpu() for g in grads], launches=launches,
                names=[n for n, _ in gen.named_parameters()])


def seq_inputs(dtype):
    """The sequence-sharded scan's inputs at SEQ_SHAPE (the model's ranges),
    in (B, L, K, D), and the weights of the loss Σ y·w."""
    b, l, kd = SEQ_SHAPE
    (u, dts, bs, cs, a, bias, dsk, _), w = fused_inputs(b, l, kd, torch.bfloat16,
                                                        torch.Generator().manual_seed(5))
    d = kd // K
    shape = (b, l, K, d)
    return [u.reshape(shape).to(dtype), dts.reshape(shape).to(dtype),
            a.reshape(K, d, 1), bs[..., None].to(dtype), cs[..., None].to(dtype),
            dsk.reshape(K, d), bias.reshape(K, d)], w.reshape(shape).float()


SEQ_NAMES = ("u", "dts", "A", "Bs", "Cs", "D", "bias")


def par_seq(group=None):
    """The sequence-sharded scan (this rank's half of L) or, without a
    group, the one-device scan: y with bf16 IO, and y and the gradients of
    Σ y·w with fp32 IO (the same bf16 values), through the fused kernel;
    with the scans' launches of the fp32 forward and backward. Without a
    group also ``local``: each half of L scanned alone from a zero state
    with bf16 IO, the y that a rank rounds to bf16 before the carried-in
    state's correction."""
    from vm_asr_tpu_torch.ops import selective_scan as scan
    from vm_asr_tpu_torch.ops.seq_scan import seq_sharded_selective_scan as seq_scan

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        args, w = seq_inputs(dtype)
        if group is not None:
            n, r = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
            ls = SEQ_SHAPE[1] // n
            cut = slice(r * ls, (r + 1) * ls)
            args = [a[:, cut] if a.dim() == 4 else a for a in args]
            w = w[:, cut]
        args = [a.clone().requires_grad_(dtype == torch.float32) for a in args]
        zero_counts()
        y = seq_scan(*args, group=group) if group is not None else scan(*args)
        if group is None and dtype == torch.bfloat16:
            ls = SEQ_SHAPE[1] // PAR_RANKS
            out["local"] = torch.cat([scan(*[a[:, r * ls:(r + 1) * ls] if a.dim() == 4 else a
                                             for a in args]).cpu() for r in range(PAR_RANKS)],
                                     dim=1)
        if dtype == torch.float32:
            out["grads"] = [g.cpu() for g in torch.autograd.grad((y.float() * w).sum(), args)]
            out["launches"] = read_counts()
        out[str(dtype)] = y.detach().cpu()
    return out


def par_rank(rank: int, init_method: str):
    """One rank of the parallel phase (spawned, two on cuda:0 over gloo)."""
    from vm_asr_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed(rank, PAR_RANKS, init_method, "cuda:0", backend="gloo")
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        spec = torch.load(PAR_DIR / "spec.pt", weights_only=False)
        cfg = parallel_config()
        res = {}
        res["dp"] = par_chain(cfg, spec["init"], spec["batches"], mesh=make_mesh(dp=PAR_RANKS),
                              ckpt_dir=PAR_DIR / "ckpt", timed=PAR_TIMED)
        mesh = make_mesh(dp=1, mp=PAR_RANKS)
        res["mp"] = par_mp(cfg, spec["init"], mesh)
        res["seq"] = par_seq(mesh.mp_group)
        torch.save(res, PAR_DIR / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def losses_vs_control(got, ref, ctrl):
    """Per key, |got − ref| over max(PAR_CONTROL_X·|ctrl − ref|, PAR_LOSS_REL
    ·|ref|): the worst ratio (≤ 1 passes), with the largest relative
    difference and the control's."""
    ratio = max(abs(got[k] - ref[k]) / max(PAR_CONTROL_X * abs(ctrl[k] - ref[k]),
                                           PAR_LOSS_REL * abs(ref[k])) for k in LOSS_KEYS)
    rel = max(abs(got[k] - ref[k]) / abs(ref[k]) for k in LOSS_KEYS)
    crel = max(abs(ctrl[k] - ref[k]) / abs(ref[k]) for k in LOSS_KEYS)
    return ratio, rel, crel


def grads_vs_control(got, ref, ctrl, names):
    """Per leaf max|got − ref| over max(max|ctrl − ref|, fp32 eps × leaf
    scale); the worst ratio and its leaf, with that leaf's max|got − ref|
    and max|ctrl − ref| over its scale."""
    worst = (0.0, None, 0.0, 0.0)
    for name, g, r, c in zip(names, got, ref, ctrl):
        scale = max(float(r.abs().max()), 1e-30)
        dg, dc = float((g - r).abs().max()), float((c - r).abs().max())
        ratio = dg / max(dc, 1.2e-7 * scale)
        if ratio > worst[0]:
            worst = (ratio, name, dg / scale, dc / scale)
    return worst


def par_cli(smi):
    """The CLI's data-parallel training on the card: the CLI's rank entry
    (``cli._rank_main``) with ``--opts MESH.DP 2``, two ranks on cuda:0 over
    gloo, each reading its 2 rows of every global batch of 4 (the
    flagship, bf16, 24 synthetic items: 5 steps and a validation batch);
    rank 0 writes the log and the checkpoints, in the reference layout."""
    import json as json_

    runs = ROOT / "build" / "chip_smoke_dp2"
    shutil.rmtree(runs, ignore_errors=True)
    argv = ["--cfg", str(CONFIG), "--tag", "dp2", "--input_sr", "16000", "--synthetic_data",
            "--synthetic_n", "24", "--opts", "TRAIN.EPOCHS", "1", "MESH.DP",
            "2", "DATA.VALID_SPLIT", "0.2", "DATA.NUM_WORKERS", "2", "TENSORBOARD.ENABLE",
            "False", "OUTPUT", str(runs)]
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        cli._rank_main, nprocs=2, start_method="spawn",
        args=(2, f"tcp://127.0.0.1:{cli._free_port()}", argv, "gloo"))
    secs = time.perf_counter() - t0
    run_dir = runs / "DualStreamInteractiveMambaUNet" / "dp2"
    files = sorted(p.name for p in run_dir.glob("checkpoint-*.pth"))
    logs = sorted(p.name for p in run_dir.glob("log*"))
    blob = torch.load(run_dir / "checkpoint-latest-G.pth", map_location="cpu", weights_only=True)
    keys = set(get_generator(flagship_config(amp=True), "cuda").state_dict())
    timing = next(json_.loads(line.split(" timing ", 1)[1]) for line in
                  (run_dir / "log_rank0.txt").read_text().splitlines() if "Epoch 0 timing" in line)
    ok = (files == [
        f"checkpoint-{k}-{m}.pth" for k in ("best", "latest") for m in ("G", "mpd")]
        and logs == ["log_rank0.txt"] and set(blob["state_dict"]) == keys
        and (blob["step"], blob["epoch"], timing["steps"]) == (5, 0, 5))
    print(f"cli, MESH.DP 2 on one card over gloo: {timing['steps']} steps of 2 rows a "
          f"rank, s/it median {statistics.median(timing['step_s']):.4f} (rank 0, host clock), "
          f"validation {timing['valid_s']:.3f} s, checkpoints {files} (keys the module's own: "
          f"{set(blob['state_dict']) == keys}), logs {logs}, {secs:.1f} s in all  [{smi}]")
    return ok, dict(seconds=secs, s_per_it=statistics.median(timing["step_s"]),
                    steps=timing["steps"], checkpoints=files)


def parallel_phase(smi):
    """The parallel phase (phase 13 of the module docstring)."""
    from vm_asr_tpu_torch.parallel import Mesh, init_distributed

    t_phase = time.perf_counter()
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    PAR_DIR.mkdir(parents=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = parallel_config()
    gen0 = get_generator(cfg, "cuda")
    init = {"generator": {k: v.cpu() for k, v in gen0.state_dict().items()},
            **{n: {k: v.cpu() for k, v in d.state_dict().items()}
               for n, d in get_discriminators(cfg, "cuda").items()}}
    del gen0
    batches = [{k: v.cpu() for k, v in train_batch(
        cfg, seeds=range(50 + TRAIN_BATCH * i, 50 + TRAIN_BATCH * (i + 1))).items()}
        for i in range(PAR_CHAIN + 1)]
    rows = batch_rows(cfg)
    print(f"the same two rows at batch 2 and at batch 4, one process, fp32 eval forward: max|diff|"
          f"/max|out| {rows:.3e} (bar {PAR_ROWS_BAR})")
    failures = [] if rows <= PAR_ROWS_BAR else ["rows' batch dependence"]
    torch.save(dict(init=init, batches=batches), PAR_DIR / "spec.pt")

    t0 = time.perf_counter()
    ref = par_chain(cfg, init, batches, ckpt_dir=PAR_DIR / "ckpt_one")
    controls = {
        "batch 8": par_chain(cfg, init, [{k: torch.cat([v, v]) for k, v in b.items()}
                                         for b in batches], ckpt_dir=PAR_DIR / "ckpt_twice"),
        "permuted": par_chain(cfg, init, [{k: v.flip(0) for k, v in b.items()} for b in batches],
                              ckpt_dir=PAR_DIR / "ckpt_permuted"),
    }
    ctrl = controls[PAR_CONTROL]
    mp_ref = par_mp(cfg, init)
    seq_ref = par_seq()
    ref_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        par_rank, args=(f"tcp://127.0.0.1:{cli._free_port()}",), nprocs=PAR_RANKS,
        start_method="spawn")
    ranks_s = time.perf_counter() - t0
    got = [torch.load(PAR_DIR / f"rank{r}.pt", weights_only=False) for r in range(PAR_RANKS)]
    report = dict(reference_s=ref_s, ranks_s=ranks_s, batch2_vs_batch4_rows=rows,
                  control=PAR_CONTROL)

    # dp2, the first step, against each control; PAR_CONTROL's gates.
    d0, d1 = got[0]["dp"], got[1]["dp"]
    same = d0["losses"] == d1["losses"] and all(
        torch.equal(a, b) for n in d0["grads"] for a, b in zip(d0["grads"][n], d1["grads"][n]))
    report["dp_step"], report["dp_chain"] = {"ranks_alike": same}, {}
    lr = cfg.TRAIN.BASE_LR
    param_lr = max(float((d0["gen_after"][k] - v).abs().max()) / lr
                   for k, v in ref["gen_after"].items())
    ckpts = sorted(p.name for p in (PAR_DIR / "ckpt").glob("*.pth"))
    for cname, c in controls.items():
        loss_ratio, loss_rel, ctrl_rel = losses_vs_control(d0["losses"][0], ref["losses"][0],
                                                           c["losses"][0])
        worst = {}
        for model in ref["grads"]:
            names = ref["names"]["generator"] if model == "generator" else \
                [f"{model}.{i}" for i in range(len(ref["grads"][model]))]
            worst[model] = grads_vs_control(d0["grads"][model], ref["grads"][model],
                                            c["grads"][model], names)
        gate = cname == PAR_CONTROL
        print(f"dp2 step (2 ranks × 2 rows) vs one process at batch 4, fp32, against the "
              f"{cname} control{' (the gate)' if gate else ' (read only)'}: first-step losses "
              f"max rel {loss_rel:.3e} (control {ctrl_rel:.3e}; worst of the bar "
              f"{loss_ratio:.3f}); gradients, worst max|diff| over the control's: " +
              ", ".join(f"{m} {r:.2f} ({n}: {a:.2e} of its scale, control {b:.2e})"
                        for m, (r, n, a, b) in worst.items()) +
              f" (bar {PAR_CONTROL_X}); ranks bitwise alike: {same}")
        if gate and (not loss_ratio <= 1 or any(w[0] > PAR_CONTROL_X for w in worst.values())
                     or not same):
            failures.append("dp2 step")
        report["dp_step"][cname] = dict(loss_rel=loss_rel, control_loss_rel=ctrl_rel,
                                        loss_of_bar=loss_ratio,
                                        worst_vs_control={m: list(v) for m, v in worst.items()})

        # Chained steps, rank-0 checkpoint, restore on both ranks, resumed step.
        chain = [losses_vs_control(d0["losses"][i], ref["losses"][i], c["losses"][i])
                 for i in range(PAR_CHAIN + 1)]
        print(f"dp2 chain against the {cname} control: {PAR_CHAIN} steps, rank-0 checkpoint "
              f"{ckpts}, restored on both ranks, 1 resumed step: losses max rel per step "
              f"{[f'{x[1]:.2e}' for x in chain]} (control {[f'{x[2]:.2e}' for x in chain]}; "
              f"worst of the bar {max(x[0] for x in chain):.3f}); generator after, max|diff| "
              f"{param_lr:.3f} lr (bar {PAR_PARAM_LR})")
        if gate and (max(x[0] for x in chain) > 1 or param_lr > PAR_PARAM_LR or
                     ckpts != ["checkpoint-latest-G.pth", "checkpoint-latest-mpd.pth"] or
                     d0["gen_after"].keys() != ref["gen_after"].keys()):
            failures.append("dp2 chain and resume")
        report["dp_chain"][cname] = dict(
            loss_rel=[x[1] for x in chain], control_loss_rel=[x[2] for x in chain],
            loss_of_bar=[x[0] for x in chain], param_max_diff_lr=param_lr, checkpoints=ckpts)

    # dp1 × mp2.
    m0, m1 = got[0]["mp"], got[1]["mp"]
    fwd_rel = float((m0["out"] - mp_ref["out"]).abs().max() / mp_ref["out"].abs().max())
    bad = [n for n, g, r in zip(mp_ref["names"], m0["grads"], mp_ref["grads"])
           if not torch.allclose(g, r, **MP_GRAD_TOL)]
    grad_err = max(float(((g - r).abs() - MP_GRAD_TOL["rtol"] * r.abs()).max())
                   for g, r in zip(m0["grads"], mp_ref["grads"]))
    alike = torch.equal(m0["out"], m1["out"]) and all(
        torch.allclose(a, b, **MP_GRAD_TOL) for a, b in zip(m0["grads"], m1["grads"]))
    print(f"dp1×mp2 (each rank scans 2 of the 4 directions), fp32: forward max|diff|/max|ref| "
          f"{fwd_rel:.3e} (bar {MP_FWD_REL}); gradients outside rtol/atol {MP_GRAD_TOL}: {bad} "
          f"(max |diff| - rtol·|ref| {grad_err:.3e}); ranks alike: {alike}; a forward's "
          f"launches per rank {m0['launches']} (one process {mp_ref['launches']})")
    if not fwd_rel <= MP_FWD_REL or bad or not alike or m0["launches"] != mp_ref["launches"]:
        failures.append("mp2")
    report["mp"] = dict(forward_rel=fwd_rel, grads_outside=bad, launches=m0["launches"])

    # The sequence-sharded scan.
    s0, s1 = got[0]["seq"], got[1]["seq"]
    errs, seq_bad = {}, []
    for key in ("torch.float32", "torch.bfloat16"):
        y, r = torch.cat([s0[key], s1[key]], dim=1).float(), seq_ref[key].float()
        errs[key] = float((y - r).abs().max())
        if key == "torch.float32":
            ok = torch.allclose(y, r, **SEQ_TOL)
        else:  # each element within its own bf16 roundings 
            bar = 2.0 ** -8 * seq_ref["local"].float().abs() + 2.0 ** -7 * r.abs() + \
                SEQ_TOL["atol"]
            errs["bf16_of_bar"] = float(((y - r).abs() / bar).max())
            ok = errs["bf16_of_bar"] <= 1
        if not ok:
            seq_bad.append(key)
    for i, name in enumerate(SEQ_NAMES):
        g = torch.cat([s0["grads"][i], s1["grads"][i]], dim=1) if name in ("u", "dts", "Bs", "Cs") \
            else s0["grads"][i]
        errs[f"d{name}"] = float((g - seq_ref["grads"][i]).abs().max())
        if not torch.allclose(g, seq_ref["grads"][i], **SEQ_GRAD_TOL):
            seq_bad.append(f"d{name}")
    print(f"sequence-sharded scan over 2 ranks at {SEQ_SHAPE} (B, L, K·D), fused kernel: max|diff| "
          f"vs the one-device kernel {', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (y fp32 "
          f"{SEQ_TOL}, bf16 each element within 2^-8·|y_local| + 2^-7·|y| + "
          f"{SEQ_TOL['atol']}, gradients {SEQ_GRAD_TOL}); outside: {seq_bad}; launches "
          f"per rank {s0['launches']}")
    if seq_bad or not s0["launches"]["selective_scan_fused"] or \
            not s0["launches"]["selective_scan_fused_bwd"]:
        failures.append("sequence-sharded scan")
    report["seq"] = dict(max_abs_err=errs, outside=seq_bad, launches=s0["launches"])

    # NCCL at world size 1: the dp step's collectives through NCCL.
    init_distributed(0, 1, f"tcp://127.0.0.1:{cli._free_port()}", "cuda:0")
    try:
        nccl = par_chain(cfg, init, batches, mesh=Mesh(1, 1, 0, torch.distributed.group.WORLD))
        backend = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    nccl_ratio, nccl_rel, _ = losses_vs_control(nccl["losses"][0], ref["losses"][0],
                                                ctrl["losses"][0])
    nccl_worst = {m: grads_vs_control(nccl["grads"][m], ref["grads"][m], ctrl["grads"][m],
                                      [str(i) for i in range(len(ref["grads"][m]))])[0]
                  for m in ref["grads"]}
    print(f"{backend} at world size 1, the dp step's all_reduce path: losses max rel "
          f"{nccl_rel:.3e}, gradients worst vs control {nccl_worst}")
    if backend != "nccl" or nccl_ratio > 1 or \
            any(r > PAR_CONTROL_X for r in nccl_worst.values()):
        failures.append("nccl world size 1")
    report["nccl"] = dict(loss_rel=nccl_rel, worst_vs_control=nccl_worst)

    cli_ok, report["cli"] = par_cli(smi)
    if not cli_ok:
        failures.append("cli MESH.DP 2")

    step_ms = [statistics.median(got[r]["dp"]["step_ms"]) for r in range(PAR_RANKS)]
    report.update(dp2_step_ms=step_ms, phase_s=time.perf_counter() - t_phase)
    print(f"dp2 fp32 flagship GAN step, 2 rows a rank: median {step_ms[0]:.1f} / {step_ms[1]:.1f} "
          f"ms (ranks 0 / 1, {PAR_TIMED} steps)  [{smi}]. Two processes time-slice one card "
          f"over gloo: no measure of scaling.")
    print(f"parallel phase {report['phase_s']:.1f} s (reference runs {ref_s:.1f} s, ranks "
          f"{ranks_s:.1f} s)  [{smi}]")
    if failures:
        raise AssertionError(f"parallel phase failed: {failures}")
    return report


# The VMamba classifier at its defaults (models/vssm.py: dims 96, depths
# 2-2-9-2, d_state 16) on a 224×224×3 image: stages at 56², 28², 14², 7²
# with K·d_inner = 768..6144; without a gradient every SS2D takes the
# N-state kernel, with one the general-N route, one recurrence launch a
# state channel. (L, K·D) → SS2Ds.
VSSM_SCANS = {(3136, 768): 2, (784, 1536): 2, (196, 3072): 9, (49, 6144): 2}
VSSM_N = 16
VSSM_IMAGE = 224
VSSM_BATCH = 8       # the forwards
VSSM_GRAD_BATCH = 2  # the gradient: 16 saved (B, L, K·D) fp32 states an SS2D
# The JAX package's counts for VSSM() (vm_asr_tpu/models/vssm.py), taken on
# the CPU: jax.eval_shape of its init, and core/profiling.matmul_flops of
# its batch-1 224² forward with the "ref" scan.
VSSM_PARAMS = 43_762_024
VSSM_MATMUL_FLOPS = 14_494_371_840
# The fp32 logits, kernels against the plain scan, max |diff| / max |plain|
# (TF32 off): the scans' ~1e-7 differences through 15 SS2Ds, as the
# flagship forward's MODEL_REL_TOL; a wrong kernel moves them by O(1).
VSSM_REL_TOL = MODEL_REL_TOL


def vssm_bound_ms(batch: int):
    """The recurrence's bound over one forward's 240 calls (a, b read, h
    written, fp32) and over one backward's reverse calls (a, h, g read, da,
    dh written)."""
    elems = sum(n * VSSM_N * batch * l * d for (l, d), n in VSSM_SCANS.items())
    return bound_ms(3 * elems * 4, LR_OPS * elems), bound_ms(5 * elems * 4, LR_REV_OPS * elems)


def vssm_phase(smi):
    """The VMamba classifier at its full default width on the card (phase 14
    of the module docstring). Returns the report."""
    report = {}
    scans = sum(VSSM_SCANS.values())
    launches = scans * VSSM_N
    want_fwd = dict(selective_scan_fused=0, selective_scan_fused_bwd=0, linear_recurrence=0,
                    linear_recurrence_reverse=0, selective_scan_nstate=scans)
    model = get_vssm("cuda", seed=0)
    params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(VSSM_BATCH, VSSM_IMAGE, VSSM_IMAGE, 3, device="cuda", generator=gen)
    seen = Counter()
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.update([(inp[0].shape[1] * inp[0].shape[2], K * mod.d_inner)]))
        for m in model.modules() if isinstance(m, SS2D)]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    with torch.inference_mode():
        for impl in ("kernel", "plain", "plain64"):
            set_scan_impl(model, impl)
            zero_counts()
            out[impl] = model(x)
            torch.cuda.synchronize()
            report[f"{impl}_launches"] = vssm_counts()
            for h in hooks:
                h.remove()
            hooks = []
    set_scan_impl(model, "kernel")
    scale = out["plain64"].abs().max()
    rel = {name: ((out[a] - out[b]).abs().max() / s_).item() for name, a, b, s_ in (
        ("kernel_vs_plain", "kernel", "plain", out["plain"].abs().max()),
        ("kernel_vs_fp64", "kernel", "plain64", scale), ("plain_vs_fp64", "plain", "plain64", scale))}
    finite = bool(torch.isfinite(out["kernel"]).all())
    print(f"VSSM(): {params} parameters (JAX {VSSM_PARAMS}); fp32 logits "
          f"{tuple(out['kernel'].shape)} at batch {VSSM_BATCH}, finite {finite}; max|kernel - "
          f"plain| / max|plain| {rel['kernel_vs_plain']:.3e} (tol {VSSM_REL_TOL}); against the "
          f"plain scan in fp64: kernels {rel['kernel_vs_fp64']:.3e}, plain fp32 "
          f"{rel['plain_vs_fp64']:.3e}; launches {report['kernel_launches']}; TF32 off")
    if dict(seen) != VSSM_SCANS or params != VSSM_PARAMS or not finite \
            or out["kernel"].shape != (VSSM_BATCH, 1000) or not rel["kernel_vs_plain"] <= VSSM_REL_TOL \
            or report["kernel_launches"] != want_fwd or any(report["plain_launches"].values()) \
            or any(report["plain64_launches"].values()):
        raise AssertionError(f"vssm forward failed: scans {dict(seen)}, {report}, {rel}")
    report.update(params=params, rel=rel, tol=VSSM_REL_TOL)
    del out

    # bf16 compute, batch 8: wall, busy, idle share, the N-state kernel's time.
    model16 = get_vssm("cuda", seed=0, compute_dtype=torch.bfloat16)
    model16.load_state_dict(model.state_dict())
    fwd = lambda: model16(x)  # noqa: E731
    nstate_names = set(NSTATE_KERNELS["scan"])
    with torch.inference_mode():
        wall = cuda_ms(fwd, reps=5, per=1)
        for _ in range(3):  # a capture that dropped events counts the calls short
            events = device_kernels(fwd)
            calls = by_wrapper(events)[1]
            nstate = [(e_ - s_) / 1e3 for name, s_, e_ in events if name in nstate_names]
            if len(nstate) == scans:
                break
    busy = busy_us(events) / 1e3
    by_name = Counter()
    for name, s_, e_ in events:
        by_name[name] += (e_ - s_) / 1e3
    report["bf16_forward"] = dict(
        batch=VSSM_BATCH, wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
        device_events=len(events), nstate_device_ms=sum(nstate), nstate_calls=len(nstate),
        other_scan_calls=dict(calls), images_per_s=VSSM_BATCH / (wall / 1e3),
        top=by_name.most_common(10))
    print(f"bf16 forward, batch {VSSM_BATCH}: wall {wall:.2f} ms (CUDA events), device busy "
          f"{busy:.2f} ms in {len(events)} events, idle share {1 - busy / wall:.3f}; the "
          f"N-state kernel {sum(nstate):.3f} ms device in {len(nstate)} calls by kernel name; "
          f"{VSSM_BATCH / (wall / 1e3):.1f} images/s  [{smi}]")
    for n, t in by_name.most_common(10):
        print(f"  {t:8.3f} ms  {n[:100]}")
    if len(nstate) != scans or any(calls.values()):
        raise AssertionError(f"bf16 forward: {len(nstate)} N-state calls by kernel name, "
                             f"other scans {dict(calls)}")
    del model16

    # fp32 gradient of <logits, a seeded cotangent>, batch 2, kernels vs plain.
    xg = x[:VSSM_GRAD_BATCH].clone()
    ct = torch.randn(VSSM_GRAD_BATCH, 1000, device="cuda", generator=gen)
    named = list(model.named_parameters())
    grads, peaks, counts = {}, {}, {}
    for impl in ("kernel", "plain"):
        set_scan_impl(model, impl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        logits = model(xg)
        grads[impl] = torch.autograd.grad((logits * ct).sum(), [p_ for _, p_ in named])
        torch.cuda.synchronize()
        counts[impl] = vssm_counts()
        peaks[impl] = torch.cuda.max_memory_allocated() / 1e9
        del logits
    set_scan_impl(model, "kernel")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    top = max(g_.abs().max().item() for g_ in grads["plain"])
    ratios = [((k_ - p_).abs().max() / (GRAD_REL * p_.abs().max() + GRAD_FLOOR * top)).item()
              for k_, p_ in zip(grads["kernel"], grads["plain"])]
    worst = int(np.argmax(ratios))
    zero = [n for (n, _), g_ in zip(named, grads["kernel"])
            if ".op." in n and not g_.abs().max().item() > 0]
    want_grad = dict(want_fwd, linear_recurrence=launches, linear_recurrence_reverse=launches,
                     selective_scan_nstate=0)
    report["gradient"] = dict(
        batch=VSSM_GRAD_BATCH, worst_ratio=ratios[worst], worst_tensor=named[worst][0],
        rel=GRAD_REL, floor=GRAD_FLOOR, top=top, launches=counts["kernel"],
        peak_memory_gb=peaks, zero_ss2d_gradients=zero, reverse_bound_ms=vssm_bound_ms(
            VSSM_GRAD_BATCH)[1][0])
    print(f"fp32 gradient, batch {VSSM_GRAD_BATCH}: worst of the bar ({GRAD_REL} of each "
          f"tensor's scale + {GRAD_FLOOR} of the largest, {top:.3e}) kernels vs plain "
          f"{ratios[worst]:.3e} ({named[worst][0]}); zero SS2D gradients {zero}; launches "
          f"{counts['kernel']}; max_memory_allocated {peaks['kernel']:.2f} GB (plain scan "
          f"{peaks['plain']:.2f} GB)  [{smi}]")
    if ratios[worst] > 1 or zero or counts["kernel"] != want_grad or any(counts["plain"].values()):
        raise AssertionError(f"vssm gradient failed: {report['gradient']}")
    del grads

    # BackboneVSSM's features at 224², and the FLOP count of the batch-1 forward.
    backbone = get_vssm("cuda", seed=0, cls=BackboneVSSM)
    with torch.inference_mode():
        zero_counts()
        feats = backbone(x[:1])
        bb_counts = vssm_counts()
        one = x[:1].clone()
        flops = matmul_flops(model, one)
        total = model_flops(model, one)
    shapes = [tuple(f.shape) for f in feats]
    want_shapes = [(1, 28, 28, 192), (1, 14, 14, 384), (1, 7, 7, 768), (1, 7, 7, 768)]
    report.update(backbone_shapes=shapes, backbone_launches=bb_counts, matmul_flops=flops,
                  model_gflops=total)
    print(f"BackboneVSSM features {shapes}, finite {all(bool(torch.isfinite(f).all()) for f in feats)}; "
          f"launches {bb_counts}; matmul_flops of the batch-1 forward {flops} (JAX "
          f"{VSSM_MATMUL_FLOPS}); model_flops {total['gflops']:.4f} GFLOP (scan "
          f"{total['scan_gflops']:.4f})")
    if shapes != want_shapes or not all(bool(torch.isfinite(f).all()) for f in feats) \
            or bb_counts != want_fwd or flops != VSSM_MATMUL_FLOPS:
        raise AssertionError(f"vssm backbone or FLOP count failed: {report}")
    return report


TRAJECTORY_EPOCHS = 12
TRAJECTORY_TIMEOUT_S = 900


def trajectory_phase(smi):
    """python -m vm_asr_tpu_torch.trajectory and ... --gan, the two arms
    side by side in two processes on the card (each host-bound, one CPU
    core apiece): the port's Trainer against the JAX Trainer's recorded
    curves in fp32, with the chaos floor and the defect; fails when an arm
    exits non-zero (a gap over its gate, or a defect that breaks no gate) or
    its summary says the defect went through. The scans' launches are each
    process's own count over its three runs (``launches`` in
    gaps_{arm}.json)."""
    out_dir = OUT / "trajectory"
    procs = {}
    for arm, flag in (("nogan", []), ("gan", ["--gan"])):
        log = open(OUT / f"trajectory_{arm}.log", "w")
        procs[arm] = (subprocess.Popen(
            [sys.executable, "-m", "vm_asr_tpu_torch.trajectory", "--epochs",
             str(TRAJECTORY_EPOCHS), "--out", str(out_dir)] + flag,
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log)
    rcs = {}
    try:
        for arm, (proc, _) in procs.items():
            rcs[arm] = proc.wait(timeout=TRAJECTORY_TIMEOUT_S)
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    out, launches = {}, Counter()
    for arm in procs:
        print((OUT / f"trajectory_{arm}.log").read_text().rstrip() + f"  [{smi}]")
        path = out_dir / f"gaps_{arm}.json"
        out[arm] = json.loads(path.read_text()) if rcs[arm] in (0, 1) and path.exists() else None
        if out[arm] is not None:
            launches.update(out[arm]["launches"])
    launches = {fn.__name__: launches[fn.__name__] for fn in COUNTED}
    caught = {arm: s["defect"]["caught"] for arm, s in out.items() if s is not None}
    print(f"trajectory: exit codes {rcs}; defect caught {caught}; launches over both arms "
          f"{launches}")
    if (any(rcs.values()) or not all(launches.values())
            or sorted(arm for arm, hit in caught.items() if hit) != sorted(procs)):
        raise AssertionError(f"trajectory failed: exit codes {rcs}; defect caught {caught}; "
                             f"launches {launches}")
    return dict(arms=out, launches=launches)


def checks_phase(smi):
    """``python -m vm_asr_tpu_torch.checks --grid`` in-process, on the card
    (phase 15 of the module docstring);
    its failure fails the run. Returns its numbers and its launches."""
    zero_counts()
    out = port_checks.run(["--grid"])  # main() is run() and exit code 0
    launches = read_counts()
    print(f"checks launches {launches}  [{smi}]")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched by the checks: {launches}")
    return dict(out, launches=launches)



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the card",
              file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    report = {}
    t_start = time.perf_counter()

    t0 = phase("device")
    smi = nvidia_smi_line()
    print(smi)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    report["device"] = dict(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = phase("build")
    hold_proc, HOLD_LIB[0] = hold_build_start()
    built = build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s (nvcc, in parallel)")
    if hold_proc is not None:
        log, _ = hold_proc.communicate()
        if hold_proc.returncode != 0:
            raise RuntimeError(f"nvcc of the contention check's hold kernel failed:\n{log}")
    report["build_s"] = time.perf_counter() - t0
    # The host C++ library, which the data phases load; a failed build fails the run.
    report["host_build_s"] = native.build()
    print(f"built the host library {native.library_path().name} in "
          f"{report['host_build_s']:.2f} s (g++; 0.00: already built)  [{smi}]")
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
    # The classifier's shapes (vssm phase): L = 3136..49, none a multiple of
    # the 128-step tile, at D = 768..6144; forward at its batch 8, reverse at
    # its gradient's batch 2.
    for (l, d) in VSSM_SCANS:
        checks.append(check_lr(VSSM_BATCH, l, d, gen))
        checks.append(check_lr_reverse(VSSM_GRAD_BATCH, l, d, gen))
    for c in checks:
        passes = "not measured" if c["passes"] is None else \
            ", ".join(f"{p} {t:.4f}" for p, t in c["passes"].items())
        extra = "; bitwise repeatable"
        if "cold_ms" in c:
            extra = f"; cold L2 {c['cold_ms']:.4f} ms{extra}"
        if "window" in c:
            extra = f"; W {c['window']}{extra}, also on {CAPPED_CTAS} CTAs"
        if "empty_captures" in c:
            extra = (f"{extra}; one kernel per call ({c['empty_captures']} empty captures "
                     f"taken again)")
        if "h0_max_abs_err" in c:
            extra = f"; H0 max|err| {c['h0_max_abs_err']:.3e} (tol {FP32_TOL}){extra}"
        print(f"{c['kernel']} {tuple(c['shape'])} {c['dtype'][6:]}: max|err| "
              f"{c['max_abs_err']:.3e} (tol {c['tol']}) kernel {c['ms']:.4f} ms "
              f"(device {fmt_ms(c['device_ms'])}: {passes}){extra}, plain "
              f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']}, "
              f"{c['bytes'] / 1e6:.2f} MB)")
    report["kernel_checks"] = checks
    report["layer_norm"] = layer_norm_process(smi)
    print(f"kernels checked in {time.perf_counter() - t0:.1f} s")

    t0 = phase("look-back under contention: the one-launch scans while another kernel holds "
               "all but a few SMs")
    report["lookback_contention"] = lookback_contention(gen)
    print(f"contention checked in {time.perf_counter() - t0:.1f} s  [{smi}]")

    t0 = phase("look-back in CUDA graphs: the one-launch scans captured and replayed, and "
               "across the epoch's wrap")
    report["graph_checks"] = graph_checks(gen)
    print(f"graphs checked in {time.perf_counter() - t0:.1f} s")

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
    cfg32 = flagship_config(amp=False, gan=True).defrost()
    # DropPath off: at batch 1 a dropped block legitimately has zero gradient,
    # which would hide a scan that drops it.
    cfg32.MODEL.VSSM.DROP_PATH_RATE = 0.0
    cfg32.freeze()
    report["train_grad_check"] = gradient_check(cfg32, dict(
        selective_scan_fused=30, selective_scan_fused_bwd=30, linear_recurrence=4,
        linear_recurrence_reverse=4))
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
    requests, forwards, serve_launches = [], 0, Counter()
    for name, sec in clips.items():
        out, wall = serve(name)
        n_in = int(round(sec * 48000))
        n_pad = seg if n_in <= seg else -(-n_in // seg) * seg
        n_seg = num_segments(n_pad, seg, cfg.INFERENCE.OVERLAP) if n_pad > seg else 1
        n_fwd = sum(segment_bucket_counts(n_seg).values())
        # The scans that ran on the card in a request: its forwards replay
        # CUDA graphs, whose kernels the host does not launch one by one.
        calls = device_scan_calls(lambda name=name: serve(name), forward_counts(n_fwd))
        ok = bool(torch.isfinite(out).all()) and out.shape == (1, 1, n_pad)
        r = dict(name=name, audio_s=sec, wall_s=wall, rtf=wall / sec, cold_wall_s=cold[name],
                 forwards=n_fwd, fused_launches=calls["selective_scan_fused"],
                 lr_launches=calls["linear_recurrence"], out_samples=out.shape[-1],
                 finite_and_length_ok=ok)
        print(json.dumps(r))
        if not ok or calls != forward_counts(n_fwd):
            raise AssertionError(f"serve {name}: {r}; scan calls on the device {calls}")
        requests.append(r)
        serve_launches.update(calls)
        forwards += n_fwd
    print(f"serve: {len(requests)} requests, {forwards} forwards, scan calls on the device "
          f"(profiled requests) {dict(serve_launches)}")
    report["serve"] = requests
    print(f"served in {time.perf_counter() - t0:.1f} s")

    t0 = phase("serve: the graphed forward at every bucket against the eager forward, bf16")
    report["graphed_forward"] = graphed_forward_check(inferencer)
    print(f"graphed forward checked in {time.perf_counter() - t0:.1f} s  [{smi}]")

    t0 = phase("profile: one batch-1 forward (a graph's replay), bf16")
    x = torch.from_numpy(speech_like(seg / 48000, 48000, seed=2)[None, None]).cuda()
    hf = torch.tensor([inferencer.load_input(paths["one_segment_2.555s"])[1].item()],
                      device="cuda")
    fwd = lambda: inferencer.forward(x, hf)
    wall_ms = cuda_ms(fwd, reps=5, per=1)
    events = device_kernels(fwd)
    busy = busy_us(events) / 1e3
    report["replay_vs_eager"] = replay_vs_eager(inferencer, x, hf)
    by_name = Counter()
    for name, s_, e_ in events:
        by_name[name] += (e_ - s_) / 1e3
    scan_ms = sum(by_wrapper(events)[0].values())
    ln_ms = sum(e_ - s_ for name, s_, e_ in events if name in LN_NAMES) / 1e3
    if torch_ln_events(events) or (events and ln_events(events) != 114):
        raise AssertionError(f"profiled forward: {ln_events(events)} LayerNorm kernel calls "
                             f"(want 114), {torch_ln_events(events)} of torch's LayerNorm")
    prof = dict(wall_ms=wall_ms, device_busy_ms=busy if events else None,
                device_events=len(events), scan_kernels_ms=scan_ms, layer_norm_ms=ln_ms,
                idle_share=(1 - busy / wall_ms) if events else None,
                top=[(n, t) for n, t in by_name.most_common(8)])
    idle = "not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.3f}"
    print(f"forward: wall {wall_ms:.2f} ms, device busy {fmt_ms(prof['device_busy_ms'])} "
          f"in {len(events)} device events, scan kernels {scan_ms:.3f} ms, LayerNorm kernel "
          f"{ln_ms:.3f} ms in {ln_events(events)} calls (none of torch's), idle share {idle}")
    for n, t in prof["top"]:
        print(f"  {t:8.3f} ms  {n[:100]}")
    report["profile"] = prof
    print(f"profiled in {time.perf_counter() - t0:.1f} s")

    t0 = phase("train: flagship GAN train step, batch 4, bf16")
    cfg = flagship_config(amp=True, gan=True)
    n_steps = 10
    g = gan_steps(cfg, 30, 4, 3, n_steps)
    model, discs, run, step_ms, median_ms = g.model, g.discs, g.run, g.step_ms, g.median_ms
    train_launches, peak_gb, values, per_step = g.launches, g.peak_gb, g.values, g.per_step
    want = dict(selective_scan_fused=30, selective_scan_fused_bwd=30, linear_recurrence=4,
                linear_recurrence_reverse=4)
    print(f"{n_steps} steps: median {median_ms:.2f} ms/step (CUDA events; min "
          f"{min(step_ms):.2f}, max {max(step_ms):.2f}), "
          f"{TRAIN_BATCH * cfg.DATA.SEGMENT / (median_ms / 1e3):.2f}x real time, peak "
          f"memory {peak_gb:.2f} GB; launches per step {per_step}")
    print(f"first step {json.dumps(values[0])}")
    print(f"last step {json.dumps(values[-1])}")
    unchanged = g.unchanged
    print(f"finite {g.finite}; parameters changed {g.changed} of {g.tensors} tensors; "
          f"unchanged, with the first step's max|grad| (AdamW eps {g.eps}): {unchanged}")
    if not g.finite or per_step != want or g.stuck:
        raise AssertionError(f"train phase failed; unchanged with a gradient: {g.stuck}")
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
    report["train"]["dims24"] = dims24_step(smi)
    print(f"trained in {time.perf_counter() - t0:.1f} s")

    t0 = phase("scan routes: autograd Function (main path) against dispatcher op "
               "(checkpointed blocks), bf16 batch 4")
    host = route_host_us(gen)
    for name, c in host.items():
        if isinstance(c, dict):
            print(f"{name} x{c['calls_per_step']}: host us per call, forward "
                  f"{c['function_fwd_us']:.1f} (Function) vs {c['op_fwd_us']:.1f} (op), "
                  f"forward + backward {c['function_fwd_bwd_us']:.1f} vs {c['op_fwd_bwd_us']:.1f}")
    steps = route_step_ms(model, run)
    print(f"op route over one step's scan calls: host +{host['step_fwd_delta_us']:.1f} us "
          f"forward, +{host['step_fwd_bwd_delta_us']:.1f} us forward + backward; train step "
          f"{steps['function_ms']:.2f} ms (Function) vs {steps['op_ms']:.2f} ms (op), medians "
          f"of {steps['steps_per_route']} steps each  [{smi}]")
    report["scan_routes"] = dict(host_us=host, step=steps)
    print(f"routes timed in {time.perf_counter() - t0:.1f} s")
    del model, discs, run, g

    t0 = phase("cli: train, resume, eval, throughput (vm_asr_tpu_torch.cli, flagship, batch 4)")
    report["cli"], cli_launches = cli_phase(smi, idle)
    print(f"cli phase in {time.perf_counter() - t0:.1f} s")

    t0 = phase("variants: the SINGLE/P2M/M2P configs and the other generator options, "
               "flagship width")
    report["variants"], single_launches = variants_phase(smi)
    print(f"variants phase in {time.perf_counter() - t0:.1f} s")

    t0 = phase("stacked and adversarial options: the stream-stacked generator (kernels with "
               "parameter sets, serve, CLI) and the GAN step with the MSD, the stacked MPD "
               "and wgan-gp")
    report["stacked"] = stacked_phase(smi, report["cli"]["throughput"]["segments_per_second"],
                                      report["train"])
    print(f"stacked phase in {time.perf_counter() - t0:.1f} s")

    t0 = phase("raw corpus: host C++ library, FLAC decode, degradation, pipelines, then the "
               "flagship trained from a FLAC tree (DATA.PIPELINE grain) and --eval")
    report["raw_corpus"], raw_launches = raw_corpus_phase(smi)

    t0 = phase("parallel: dp2 and dp1×mp2 on two ranks of cuda:0 over gloo, the "
               "sequence-sharded fused scan, NCCL at world size 1 (flagship, fp32)")
    report["parallel"] = parallel_phase(smi)

    t0 = phase("vssm: the VMamba classifier at its defaults (dims 96, depths 2-2-9-2, "
               "d_state 16), 224x224x3, through the N-state kernel")
    report["vssm"] = vssm_phase(smi)
    print(f"vssm phase in {time.perf_counter() - t0:.1f} s")

    t0 = phase("checks: python -m vm_asr_tpu_torch.checks --grid")
    report["checks"] = checks_phase(smi)
    print(f"checks phase in {time.perf_counter() - t0:.1f} s")

    t0 = phase("trajectory: python -m vm_asr_tpu_torch.trajectory [--gan], 12 epochs, fp32, "
               "against the JAX Trainer's recorded curves")
    report["trajectory"] = trajectory_phase(smi)
    print(f"trajectory phase in {time.perf_counter() - t0:.1f} s")

    t0 = phase("N-state scan: the d_state-16 kernel at the classifier's shapes, batch 8 and 128")
    report["nstate"] = nstate_process(smi)
    print(f"N-state scan checked in {time.perf_counter() - t0:.1f} s")

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
                    library_ms=None, check="pass", cli_launches=cli_launches[name],
                    single_cli_launches=single_launches[name],
                    raw_corpus_launches=raw_launches[name],
                    per="one batch-4 train step, summed over its calls",
                    **report["stacked"]["summary"][name], **extra)

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
    # The classifier's launches and the scans' times beside their bounds:
    # the N-state kernel in the profiled bf16 forward (vssm phase); the
    # recurrence, which runs its SS2Ds only under autograd, summed over a
    # batch-8 forward's or a batch-2 gradient's calls from the kernels
    # phase's rows at its shapes; every kernel's launches in the checks phase.
    vssm, fwd16 = report["vssm"], report["vssm"]["bf16_forward"]

    def per_vssm_pass(name, batch):
        rows = {tuple(c["shape"]): c for c in checks if c["kernel"] == name}
        calls = {(batch, l, d): VSSM_N * n for (l, d), n in VSSM_SCANS.items()}
        out = {key: sum(n * rows[s][key] for s, n in calls.items())
               for key in ("ms", "plain_ms", "bound_ms")}
        dev = [rows[s]["device_ms"] for s in calls]
        out["device_ms"] = None if None in dev else sum(
            n * rows[s]["device_ms"] for s, n in calls.items())
        return out

    for k in kernels:
        k["checks_launches"] = report["checks"]["launches"][k["name"]]
        k["dims24_launches_per_step"] = report["train"]["dims24"]["launches_per_step"][k["name"]]
        k["trajectory_launches"] = report["trajectory"]["launches"][k["name"]]
        k["vssm_forward_launches"] = vssm["kernel_launches"][k["name"]]
        k["vssm_gradient_launches"] = vssm["gradient"]["launches"][k["name"]]
    lr_vssm = per_vssm_pass("linear_recurrence", VSSM_BATCH)
    rev_vssm = per_vssm_pass("linear_recurrence_reverse", VSSM_GRAD_BATCH)
    kernels[2].update(vssm_forward=lr_vssm)
    kernels[3].update(vssm_gradient=rev_vssm)
    print(f"N-state kernel in the profiled bf16 VSSM forward (batch {VSSM_BATCH}): "
          f"{fwd16['nstate_device_ms']:.4f} ms device in {fwd16['nstate_calls']} calls; "
          f"recurrence per VSSM forward under autograd (batch {VSSM_BATCH}, "
          f"{sum(VSSM_SCANS.values()) * VSSM_N} calls): "
          f"back to back {fmt_ms(lr_vssm['device_ms'])} device, {lr_vssm['ms']:.4f} ms wrapper; "
          f"bound {lr_vssm['bound_ms']:.4f} ms. Reverse per VSSM gradient (batch "
          f"{VSSM_GRAD_BATCH}): {fmt_ms(rev_vssm['device_ms'])} device, {rev_vssm['ms']:.4f} ms "
          f"wrapper; bound {rev_vssm['bound_ms']:.4f} ms  [{smi}]")
    if any(c["bound_by"] != "bytes" for c in checks):
        raise AssertionError("a kernel check came out operation-bound; update bound_by")
    report["kernels"] = kernels
    report["script_s"] = time.perf_counter() - t_start
    (OUT / "report.json").write_text(json.dumps(report, indent=1))
    print(f"chip_smoke: every phase passed in {report['script_s']:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
