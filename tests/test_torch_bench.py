"""The port's bench (vm_asr_tpu_torch/bench.py) on the CPU at a tiny
geometry: every stage prints one well-formed line; the train stage's line
splits its step into the phases its spans record; the batched stage's FLOP
numerator equals the JAX package's count of the same generator; the scan's
byte count equals the JAX bench's expression at the JAX kernel's chunk,
but for the passes the two kernels move differently; the bench refuses to
run without CUDA unless asked for the CPU, refuses impossible shares, and
a failed stage fails the run without silencing the others."""

import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from vm_asr_tpu.core.profiling import matmul_flops as jax_matmul_flops
from vm_asr_tpu.models import DualStreamInteractiveMambaUNet as JaxDual
from vm_asr_tpu.ops.selective_scan_fused import _default_chunk as jax_chunk
from vm_asr_tpu_torch import bench
from vm_asr_tpu_torch.models import generator_kwargs, get_generator

from torch_threads import one_torch_thread  # noqa: F401

COMMON = ("metric", "value", "unit", "ms_per_call", "device_busy_ms",
          "idle_share", "device", "power_limit_w", "peak_memory_gb", "iters", "timing")
FAST = dict(warmup=1, iters=1)


def tiny_config(batch_size=1, gan=False):
    """The bench's flagship configuration at a CPU size: 48 kHz, n_fft 64,
    hop 16, 256 frames (4080 samples), dims 8, depths 1-1-1-1, a two-period
    MPD of hidden 2."""
    c = bench.flagship_config(segment_seconds=4080 / 48000, batch_size=batch_size, gan=gan)
    c.MODEL.VSSM.DIMS = 8
    c.MODEL.VSSM.DEPTHS = [1, 1, 1, 1]
    c.DATA.STFT.N_FFT = 64
    c.DATA.STFT.WIN_LENGTH = 64
    c.DATA.STFT.HOP_LENGTH = 16
    c.TRAIN.ADVERSARIAL.MPD_HIDDEN = 2
    c.TRAIN.ADVERSARIAL.MPD_PERIODS = [2, 3]
    return c


def tiny_train_config(batch_size):
    """``tiny_config`` as ``bench.train_config`` sets up the flagship."""
    c = tiny_config(batch_size, gan=True)
    c.MODEL.VSSM.FUSE_STREAMS = True
    return c


@pytest.fixture(scope="module")
def cpu():
    return bench.Card.probe("cpu")


@pytest.fixture(scope="module")
def generator():
    return get_generator(tiny_config(), "cpu")


def check_line(record, metric):
    assert set(COMMON) <= set(record), set(COMMON) - set(record)
    assert "vs_baseline" not in record
    assert record["metric"] == metric
    assert math.isfinite(record["value"]) and record["value"] > 0
    assert math.isfinite(record["ms_per_call"]) and record["ms_per_call"] > 0
    assert record["device"] == "cpu" and record["timing"] == "host_clock_diff"
    # No device to profile, no card's power limit or memory on the CPU.
    assert record["device_busy_ms"] is None and record["idle_share"] is None
    assert record["power_limit_w"] is None and record["peak_memory_gb"] is None
    assert json.loads(json.dumps(record)) == record


@pytest.mark.parametrize("stage,metric", [
    ("bench_batch1", "rtf_reciprocal_48k_batch1"),
    ("bench_stacked", "rtf_reciprocal_48k_batch1_stacked"),
    ("bench_full_clip", "rtf_reciprocal_48k_fullclip_device"),
])
def test_inference_stage_prints_a_line(cpu, generator, stage, metric):
    record = getattr(bench, stage)(cpu, generator, tiny_config(), **FAST)
    check_line(record, metric)
    audio_s = record["clip_seconds"] if stage == "bench_full_clip" else 4080 / 48000
    assert record["value"] == pytest.approx(audio_s / (record["ms_per_call"] / 1e3))
    if stage == "bench_full_clip":
        assert record["n_segments"] == 3
        # Three windows of 4080 samples, 2000 (TEST.OVERLAP) shared.
        assert record["clip_seconds"] == (4080 + 2 * 2080) / 48000


def test_batched_stage_counts_flops_as_jax_does(cpu, generator):
    """The numerator of the MFU: the port's matmul_flops of the batch-2
    forward equals the JAX package's jaxpr count of its generator at the
    same configuration (params by shape only)."""
    cfg = tiny_config()
    record = bench.bench_batched(cpu, generator, cfg, batch=2, **FAST)
    check_line(record, "rtf_reciprocal_48k_batch2")
    assert record["mfu_pct_cpu_bf16"] is None  # no peak for the CPU
    assert record["segments_per_s"] > 0

    kw = generator_kwargs(cfg)
    kw.pop("compute_dtype")
    kw.pop("scan_fp32_io")
    jm = JaxDual(scan_impl="ref", dtype=jnp.float32, **kw)
    x, hf = jnp.zeros((2, 1, 4080)), jnp.full((2,), 10)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, hf)["params"]
    want = jax_matmul_flops(lambda p, x, hf: jm.apply({"params": p}, x, hf), params, x, hf)
    assert record["matmul_flops"] == want


def test_train_stage_prints_a_line_with_its_decomposition(cpu):
    """The step's decomposition is its phases' host ms in the profiled call,
    from the step's spans; their idle ms need a device."""
    record = bench.bench_train(cpu, batch_size=2, config_fn=tiny_train_config, **FAST)
    check_line(record, "train_rt_factor_48k_MPD_batch2")
    assert record["fuse_streams"] is True
    assert not {"decomposition_ms", "decomposition_busy_ms"} & set(record)
    phases = record["phase_ms"]
    assert set(phases) == {"step", "generator", "gen_loss", "gen_backward", "gen_update",
                           "disc_loss", "disc_backward", "disc_update", "metrics"}
    assert all(math.isfinite(v) and v > 0 for v in phases.values())
    inner = sum(v for k, v in phases.items() if k != "step")
    assert inner <= phases["step"] <= record["ms_per_call"] * 10
    assert record["phase_idle_ms"] is None  # no device profile on the CPU


def test_scan_stage_prints_two_lines(cpu):
    records = bench.bench_scan_roofline(cpu, batch=2, l=300, kd=128, **FAST)
    for record, name in zip(records, ("fwd", "fwd_bwd")):
        assert record["metric"] == f"scan_{name}_hbm_roofline_pct"
        assert record["value"] is None and "vs_baseline" not in record  # no peak
        assert record["unit"] == "pct_of_cpu"
        assert record["bytes"] == bench.scan_roofline_bytes(2, 300, 128)[name]
        assert record["eff_gbs"] > 0 and record["ms_per_call"] > 0


@pytest.mark.parametrize("shape", [(8, 16384, 128), (4, 4096, 256), (2, 1536, 132)])
def test_scan_bytes_are_the_jax_bench_expression(shape):
    """bench.py:486-493 at the JAX kernel's chunk: the forward is the same
    count; forward + backward differs by the 6 (B, L, K) passes of the JAX
    backward's fp32 B/C casts and fp32 dB/dC (the port's kernels read and
    write them in the IO dtype)."""
    batch, l, kd = shape
    isz, k = 2, 4
    kd_pass = batch * l * kd * isz
    k_pass = batch * l * k * isz
    ckpt = batch * (l // jax_chunk(l)) * kd * 4
    fwd_bytes = 4 * kd_pass + 2 * k_pass + ckpt
    grad_bytes = 10 * kd_pass + 2 * ckpt + (4 + 2 * 2 + 2 * 2) * k_pass
    got = bench.scan_roofline_bytes(batch, l, kd, chunk=jax_chunk(l))
    assert got["fwd"] == fwd_bytes
    assert got["fwd_bwd"] == grad_bytes - 6 * k_pass


def test_scan_bytes_take_the_port_kernels_chunk():
    from vm_asr_tpu_torch.ops.selective_scan_fused import chunk_length

    b, l, kd = 8, 16384, 128
    chunk = chunk_length(b, l, kd)
    assert bench.scan_roofline_bytes(b, l, kd) == bench.scan_roofline_bytes(b, l, kd, chunk=chunk)
    h0 = b * (l // chunk) * kd * 4
    assert bench.scan_roofline_bytes(b, l, kd)["fwd"] == 4 * b * l * kd * 2 + 2 * b * l * 4 * 2 + h0


def test_main_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: bench.main would run the bench")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])


def test_peaks_and_impossible_shares():
    card = bench.Card(torch.device("cpu"), "NVIDIA H100 80GB HBM3", 700.0,
                      bench.PEAKS["NVIDIA H100 80GB HBM3"])
    assert card.label == "h100"
    assert card.share(989.4e12 / 2, "bf16_flops") == pytest.approx(50.0)
    assert card.share(3.35e12, "hbm_bytes_per_s") == pytest.approx(100.0)
    for rate in (3.36e12, 0.0, -1.0):
        with pytest.raises(ValueError, match="impossible"):
            card.share(rate, "hbm_bytes_per_s")


def test_a_failed_stage_fails_the_run_and_the_others_still_print(cpu, monkeypatch, capsys):
    def ok(name):
        return lambda card, *a, **k: {"metric": name}

    def broken(card, *a, **k):
        raise ValueError("stage fault")

    for name in ("bench_batch1", "bench_full_clip", "bench_batched", "bench_train",
                 "bench_scan_roofline"):
        monkeypatch.setattr(bench, name, ok(name))
    monkeypatch.setattr(bench, "bench_stacked", broken)
    with pytest.raises(RuntimeError, match=r"\['stacked'\]"):
        bench.run(cpu, config=tiny_config())
    out, err = capsys.readouterr()
    printed = [json.loads(s)["metric"] for s in out.splitlines()]
    assert printed == ["bench_batch1", "bench_full_clip", "bench_batched", "bench_train",
                       "bench_scan_roofline"]
    assert "stage fault" in err
