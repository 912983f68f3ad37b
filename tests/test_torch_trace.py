"""The port's span recorder (vm_asr_tpu_torch/core/profiling.py: ``span``,
``recorded_spans``, ``idle_by_span``) on the CPU: off without a profiler;
under one, nested spans with their parent and request or step ids, on the
clock of the profiler's own events; the phases a tiny ``infer_file`` and a
tiny GAN step record."""

import statistics

import numpy as np
import pytest
import torch

from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.core.profiling import (
    SPAN_PREFIX,
    Span,
    busy_ns,
    clear_spans,
    idle_by_span,
    recorded_spans,
    span,
)
from vm_asr_tpu_torch.dsp import num_segments, save_wav
from vm_asr_tpu_torch.models import get_discriminators, get_generator
from vm_asr_tpu_torch.train import (
    DiscState,
    GenState,
    Inferencer,
    make_optimizer,
    make_train_step,
    segment_bucket_counts,
)

from torch_threads import one_torch_thread  # noqa: F401


def cpu_profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def no_spans():
    clear_spans()
    yield
    clear_spans()


def test_off_without_a_profiler(monkeypatch):
    """No profiler: one shared object, no record, no record_function."""
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    first = span("request")
    assert span("generator", bucket=4, segments=3) is first
    with first:
        with span("load"):
            pass
    assert recorded_spans() == []


def test_nested_spans_carry_parent_and_group():
    with cpu_profiler():
        for _ in range(2):
            with span("request"):
                with span("load"):
                    pass
                with span("forward"):
                    with span("generator", bucket=4, segments=3):
                        pass
        with span("lone"):
            pass
    spans = sorted(recorded_spans(), key=lambda s: s.start_ns)
    assert [s.name for s in spans] == ["request", "load", "forward", "generator"] * 2 + ["lone"]
    assert all(isinstance(s, Span) and s.start_ns <= s.end_ns for s in spans)
    for req in (spans[:4], spans[4:8]):
        top, load, fwd, gen = req
        assert top.parent == 0 and top.group == top.id
        assert load.parent == fwd.parent == top.id and gen.parent == fwd.id
        assert {s.group for s in req} == {top.id}
        assert gen.counts == {"bucket": 4, "segments": 3} and load.counts == {}
    assert spans[0].group != spans[4].group
    assert spans[8].parent == 0 and spans[8].group == spans[8].id


def test_spans_are_on_the_profilers_clock():
    """Each span starts within 50 µs (median) of its record_function twin
    among the profiler's raw events."""
    with cpu_profiler() as prof:
        for i in range(100):
            with span(f"s{i}"):
                torch.ones(4).add_(1)
    twins = {e.name()[len(SPAN_PREFIX):]: e.start_ns()
             for e in prof.profiler.kineto_results.events() if e.name().startswith(SPAN_PREFIX)}
    spans = recorded_spans()
    assert len(spans) == 100 and set(twins) == {s.name for s in spans}
    assert statistics.median(abs(twins[s.name] - s.start_ns) for s in spans) < 50_000


def _span(name, start, end, sid=1, parent=0):
    return Span(name, sid, parent, sid if parent == 0 else parent, start, end, {})


def test_idle_goes_to_the_innermost_span_open_at_each_ns():
    spans = [_span("step", 0, 100, 1), _span("generator", 10, 40, 2, 1),
             _span("gen_backward", 40, 90, 3, 1)]
    device = [(0, 5), (20, 30), (25, 50), (95, 120)]
    assert busy_ns(device) == 5 + 30 + 25
    idle = idle_by_span(device, spans, 0, 110)
    # 5-10 step; 10-20 generator; 50-90 gen_backward; 90-95 step; 0-110 ends
    # inside a kernel. The gap 5-20 crosses step and generator and is split.
    assert idle == {"step": 10, "generator": 10, "gen_backward": 40}
    assert idle_by_span([(0, 10)], spans[:1], 0, 130) == {"step": 90, "outside": 30}


def _serve_config(tmp_path):
    """16 kHz, n_fft 128, hop 32: a segment of 992 samples (31 hops), the
    size tests/test_torch_serve.py runs, at dims 8."""
    c = default_config()
    c.MODEL.NAME = "DualStreamInteractiveMambaUNet"
    c.MODEL.VSSM.DIMS = 8
    c.MODEL.VSSM.DEPTHS = [1, 1, 1, 1]
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = 0.062
    c.DATA.STFT.N_FFT = 128
    c.DATA.STFT.WIN_LENGTH = 128
    c.DATA.STFT.HOP_LENGTH = 32
    c.AMP_ENABLE = False
    c.INFERENCE.OVERLAP = 100
    c.TAG = "16000_16000"
    c.TENSORBOARD.ENABLE = False
    c.OUTPUT = str(tmp_path / "logs")
    return c


@pytest.mark.parametrize("samples", [700, 992 + 10 * 892])
def test_infer_file_records_its_phases(tmp_path, samples):
    """request > load, forward > (unfold, generator per bucket, fold), save;
    the buckets and real segments are segment_bucket_counts's. A clip of at
    most one segment: one generator span of bucket 1."""
    c = _serve_config(tmp_path)
    path = str(tmp_path / "clip.wav")
    save_wav(path, np.random.default_rng(0).uniform(-0.5, 0.5, samples), 16000)
    inf = Inferencer(c, get_generator(c, device="cpu", seed=0), output_dir=str(tmp_path),
                     device="cpu")
    with cpu_profiler():
        inf.infer_file(path, quiet=True)
    spans = sorted(recorded_spans(), key=lambda s: s.start_ns)
    by_id = {s.id: s for s in spans}
    tree = [(s.name, by_id[s.parent].name if s.parent else None) for s in spans]
    seg = 992
    n = num_segments(-(-samples // seg) * seg, seg, 100) if samples > seg else 1
    buckets = segment_bucket_counts(n)
    gens = [s.counts for s in spans if s.name == "generator"]
    if n == 1:
        assert tree == [("request", None), ("load", "request"), ("forward", "request"),
                        ("generator", "forward"), ("save", "request")]
    else:
        assert tree == [("request", None), ("load", "request"), ("forward", "request"),
                        ("unfold", "forward")] + [("generator", "forward")] * len(gens) + [
                           ("fold", "forward"), ("save", "request")]
    assert sum(g["segments"] for g in gens) == n
    assert {b: sum(g["bucket"] == b for g in gens) for b in buckets} == buckets
    assert sum(buckets.values()) == len(gens)
    assert {s.group for s in spans} == {spans[0].id}


def _train_config():
    """The tiny GAN step of tests/test_torch_train_step.py (16 kHz, n_fft 128,
    2016 samples) at dims 8, with the MPD and the MSD."""
    c = default_config()
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = 0.126
    c.DATA.STFT.N_FFT = 128
    c.DATA.STFT.HOP_LENGTH = 32
    c.DATA.STFT.WIN_LENGTH = 128
    c.MODEL.NAME = "DualStreamInteractiveMambaUNet"
    c.MODEL.VSSM.DIMS = 8
    c.MODEL.VSSM.DEPTHS = [1, 1, 1, 1]
    c.TRAIN.ADVERSARIAL.ENABLE = True
    c.TRAIN.ADVERSARIAL.DISCRIMINATORS = ["mpd", "msd"]
    c.TRAIN.ADVERSARIAL.MPD_HIDDEN = 2
    c.TRAIN.ADVERSARIAL.MPD_PERIODS = [2, 3]
    c.TRAIN.ADVERSARIAL.MSD_HIDDEN = 16
    c.DTYPE.COMPUTE = "float32"
    c.AMP_ENABLE = False
    return c


def test_train_step_records_its_phases():
    c = _train_config()
    gen = get_generator(c, "cpu")
    discs = get_discriminators(c, "cpu")
    gen_state = GenState(gen, make_optimizer(c, 10, gen))
    disc_states = {k: DiscState(d, make_optimizer(c, 10, d)) for k, d in sorted(discs.items())}
    step = make_train_step(c, gen, discs)
    rng = np.random.default_rng(0)
    batch = {"wave_input": torch.from_numpy(rng.standard_normal((2, 1, 2016), np.float32) * 0.1),
             "wave_target": torch.from_numpy(rng.standard_normal((2, 1, 2016), np.float32) * 0.1),
             "highcut": torch.tensor([16, 40])}
    with cpu_profiler():
        step(gen_state, disc_states, batch, torch.Generator().manual_seed(0))
    spans = sorted(recorded_spans(), key=lambda s: s.start_ns)
    assert [s.name for s in spans] == [
        "step", "generator", "gen_loss", "gen_backward", "gen_update",
        "disc_loss", "disc_backward", "disc_update",
        "disc_loss", "disc_backward", "disc_update", "metrics"]
    assert [s.counts.get("disc") for s in spans[5:11]] == ["mpd"] * 3 + ["msd"] * 3
    assert all(s.parent == spans[0].id and s.group == spans[0].id for s in spans[1:])
    # Under no profiler the same step records nothing.
    clear_spans()
    step(gen_state, disc_states, batch, torch.Generator().manual_seed(1))
    assert recorded_spans() == []
