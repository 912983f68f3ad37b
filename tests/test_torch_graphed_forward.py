"""The serving forward's CUDA graphs (vm_asr_tpu_torch/train/steps.py:
``make_forward_fn``, ``GraphedForward``) and the scans' look-back workspace
(ops/lookback.py), on the CPU: on CPU tensors the forward is the eager one,
bit for bit; dsp.istft is torch.istft, bit for bit; the graph cache's
policy with its capture stubbed (eager on a signature's first sight,
capture on its second, replay after; a key per signature of every
positional input, of a one- and a two-input module; eager while a capture
runs); a replay's copies, and no launch counted for it; the
``graph_replays`` count on the ``generator`` span and the benchmark's
reader of it; a workspace that a capture could have baked in is never freed, and none is
made inside a capture."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.core.profiling import clear_spans, recorded_spans, span
from vm_asr_tpu_torch.dsp.stft import hann_window, istft
from vm_asr_tpu_torch.models import get_generator
from vm_asr_tpu_torch.ops import (
    linear_recurrence,
    linear_recurrence_reverse,
    lookback,
    selective_scan_fused,
    selective_scan_fused_bwd,
)
from vm_asr_tpu_torch.train import make_forward_fn
from vm_asr_tpu_torch.train.steps import GraphedForward, _Replay, signature

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SEG = 992  # one segment of the tiny configuration below
COUNTED = (selective_scan_fused, selective_scan_fused_bwd, linear_recurrence,
           linear_recurrence_reverse)


def _tiny_generator():
    """16 kHz, n_fft 128, hop 32, dims 8: the size tests/test_torch_trace.py
    serves."""
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
    return get_generator(c, device="cpu", seed=0)


def _inputs(bucket, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (bucket, 1, SEG)).astype(np.float32))
    return x, torch.full((bucket,), 40, dtype=torch.int64)


@pytest.mark.parametrize("bucket", [1, 2])
def test_cpu_forward_is_the_eager_forward(bucket):
    """Three calls of one signature, each bitwise the eager forward; no
    signature is kept, no graph made."""
    gen = _tiny_generator()
    forward = make_forward_fn(gen)
    for seed in range(3):
        x, hf = _inputs(bucket, seed)
        with torch.inference_mode():
            want = gen(x, hf)
        assert torch.equal(forward(x, hf), want)
    assert not gen.training
    assert forward.seen == set() and forward.graphs == {}


@pytest.mark.parametrize("b,n_fft,hop,win,frames", [(2, 128, 32, 128, 40), (1, 1024, 240, 1024, 64),
                                                    (3, 64, 16, 48, 9), (4, 1024, 240, 1024, 512),
                                                    (1, 512, 128, 512, 3), (2, 256, 64, 200, 17)])
def test_istft_is_torch_istft(b, n_fft, hop, win, frames):
    """dsp.istft, which a CUDA graph can capture, gives torch.istft's bits
    (a window shorter than n_fft among them); a hop that leaves a hole in
    the window's overlap-add envelope raises, as torch.istft does."""
    g = torch.Generator().manual_seed(b * n_fft + frames)
    spec = torch.randn(b, n_fft // 2 + 1, frames, dtype=torch.complex64, generator=g)
    want = torch.istft(spec, n_fft=n_fft, hop_length=hop, win_length=win,
                       window=hann_window(win), center=True, normalized=True, onesided=True)
    assert torch.equal(istft(spec, n_fft, hop, win), want)
    with pytest.raises(ValueError, match="envelope"):
        istft(spec, n_fft, n_fft + 7, win)


class Stubbed(GraphedForward):
    """The policy with the card's parts stubbed: any input is graphable
    unless ``capturing``; warm-up and capture are logged, and a "graph"
    replays the eager forward."""

    def __init__(self, module):
        super().__init__(module)
        self.log, self.capturing = [], False

    def graphable(self, x):
        return not self.capturing

    def warm(self, inputs):
        self.log.append(("warm", tuple(inputs[0].shape), inputs[0].dtype))
        return self.module(*inputs)

    def capture(self, inputs):
        self.log.append(("capture", tuple(inputs[0].shape), inputs[0].dtype))

        def replay(*inputs):
            self.log.append(("replay", tuple(inputs[0].shape), inputs[0].dtype))
            return self.module(*inputs)

        return replay


def _double(x, hf):
    return x * 2 + hf[:, None, None]


def test_graph_policy():
    """Eager on first sight, capture and replay on the second, replay after;
    a new key for another batch or dtype; a call while a capture runs is
    eager and changes nothing."""
    fwd = Stubbed(_double)
    a = (torch.ones(1, 1, 4), torch.zeros(1))
    b = (torch.ones(2, 1, 4), torch.zeros(2))
    c = (torch.ones(2, 1, 4, dtype=torch.float64), torch.zeros(2))
    for x, hf in (a, a, a, b, a, b, c, b, c):
        assert torch.equal(fwd(x, hf), _double(x, hf))
    one, two, f64 = ((1, 1, 4), torch.float32), ((2, 1, 4), torch.float32), \
        ((2, 1, 4), torch.float64)
    assert fwd.log == [("warm", *one), ("capture", *one), ("replay", *one), ("replay", *one),
                       ("warm", *two), ("replay", *one), ("capture", *two), ("replay", *two),
                       ("warm", *f64), ("replay", *two), ("capture", *f64), ("replay", *f64)]
    assert len(fwd.graphs) == 3 and len(fwd.seen) == 3

    fwd.capturing, fwd.log = True, []
    d = (torch.ones(4, 1, 4), torch.zeros(4))
    for x, hf in (a, d, d):
        assert torch.equal(fwd(x, hf), _double(x, hf))
    assert fwd.log == [] and len(fwd.graphs) == 3 and len(fwd.seen) == 3


@pytest.mark.parametrize("arity", [1, 2])
def test_graph_key_is_every_input(arity):
    """The key is each positional input's shape, dtype and device: a
    one-input module (the classifier's images) gets a graph per image
    shape and dtype; a two-input one (the generator's x and hf) a new one
    when only its second input changes."""
    def fn(*inputs):
        return sum(t.double().sum() for t in inputs)

    fwd = Stubbed(fn)
    x = torch.ones(2, 4, 4, 3, dtype=torch.uint8)
    calls = [(x,), (x,), (x.float(),), (x[:1],), (x.float(),)] if arity == 1 else \
        [(x, torch.zeros(2)), (x, torch.zeros(2)), (x, torch.zeros(3)),
         (x, torch.zeros(2, dtype=torch.int64)), (x, torch.zeros(3))]
    for inputs in calls:
        assert fwd(*inputs) == fn(*inputs)
    assert signature(calls[0]) == tuple((t.shape, t.dtype, t.device) for t in calls[0])
    assert len(fwd.seen) == len({signature(c) for c in calls}) == 3
    assert [e[0] for e in fwd.log] == ["warm", "capture", "replay", "warm", "warm", "capture",
                                       "replay"]
    assert len(fwd.graphs) == 2


class FakeGraph:
    """A graph whose replay runs its forward on the static tensors."""

    def __init__(self, x, hf, out):
        self.x, self.hf, self.out = x, hf, out

    def replay(self):
        self.out.copy_(_double(self.x, self.hf))


def test_replay_copies_in_and_out_and_counts_launches():
    """The inputs are copied into the static ones, the output is a copy the
    caller owns (a later replay leaves it as it was), and a replay adds
    nothing to the scan wrappers' launch counts: they count the launches the
    host issues, and a replay issues none of its kernels one by one."""
    x, hf = torch.zeros(2, 1, 4), torch.zeros(2)
    out = torch.empty(2, 1, 4)
    replay = _Replay(FakeGraph(x, hf, out), [x, hf], out)
    before = [fn.launches for fn in COUNTED]
    first = replay(torch.ones(2, 1, 4), torch.ones(2))
    second = replay(torch.full((2, 1, 4), 3.0), torch.zeros(2))
    assert torch.equal(first, torch.full((2, 1, 4), 3.0))
    assert torch.equal(second, torch.full((2, 1, 4), 6.0))
    assert first.data_ptr() != out.data_ptr() and second.data_ptr() != out.data_ptr()
    assert [fn.launches for fn in COUNTED] == before


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "benchmark" / "metrics" /
                                                  f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_generator_span_counts_replays():
    """Under a profiler each bucket forward's ``generator`` span carries
    ``graph_replays``: 0 for the first sight, 1 for the capture's replay and
    after; the benchmark's ``graph_replay_share.serve`` reads their share. A
    CPU forward adds no count, and the reader then gives nothing."""
    read = _reader("graph_replay_share.serve")
    x, hf = torch.ones(1, 1, 4), torch.zeros(1)
    cpu = make_forward_fn(torch.nn.Identity())
    cpu.module = _double
    for fwd, want, share in ((Stubbed(_double), [0, 1, 1], 2 / 3), (cpu, [None] * 3, None)):
        clear_spans()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(3):
                with span("request"), span("generator", bucket=1, segments=1):
                    fwd(x, hf)
        gens = [s.counts for s in recorded_spans() if s.name == "generator"]
        assert [g.get("graph_replays") for g in gens] == want
        assert all(g["bucket"] == 1 and g["segments"] == 1 for g in gens)
        assert read({"kind": "serve"}) == share
    assert read({"kind": "train"}) is None
    clear_spans()


def test_workspace_is_kept_and_never_made_in_a_capture(monkeypatch):
    """A workspace is reused while it is large enough; an outgrown one is
    kept (a graph may have baked in its address); inside a capture a
    workspace that is there is returned, and one that would have to be made
    or grown raises."""
    monkeypatch.setattr(lookback, "_workspaces", {})
    monkeypatch.setattr(lookback, "_outgrown", [])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    key = (torch.device("cpu"), 0x51)
    small = lookback.lookback_workspace(*key, 48)
    assert small.numel() == 48 and not small.any()
    assert lookback.lookback_workspace(*key, 24) is small
    big = lookback.lookback_workspace(*key, 96)
    assert big.numel() == 96 and lookback._outgrown == [small]

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert lookback.lookback_workspace(*key, 96) is big
    for stream, nbytes in ((0x51, 120), (0x52, 24)):
        with pytest.raises(RuntimeError, match="capture"):
            lookback.lookback_workspace(key[0], stream, nbytes)
    assert lookback._workspaces == {key: big}
