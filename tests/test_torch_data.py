"""The port's data side (dsp/degrade.py, data/vctk.py, data/pipeline.py)
against the JAX package's, on the CPU.

Everything here runs on the host, so the bar is equality: the same
filters, the same samples, the same sample ids in the same order, and
batches bitwise equal over two epochs, for training and for eval. Both
packages filter and resample 1-D signals with the same C++ library: the
JAX binding is pointed at the port's build of it (tests/torch_native.py).
"""

import importlib
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.data import pipeline as jax_pipeline
from vm_asr_tpu.data import vctk as jax_vctk
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.data import WorkerPipeline, pipeline, vctk
from tests.torch_native import jax_uses_port_native  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

# The packages export the function `degrade`, which shadows its module.
degrade = importlib.import_module("vm_asr_tpu_torch.dsp.degrade")
jax_degrade = importlib.import_module("vm_asr_tpu.dsp.degrade")


def _tiny(c, training=True, weighted=False):
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = 0.126
    c.DATA.STFT.N_FFT = 128
    c.DATA.RANDOM_RESAMPLE = [2000, 16000]
    c.DATA.BATCH_SIZE = 3
    c.DATA.NUM_WORKERS = 2
    c.DATA.VALID_SPLIT = 0.25
    c.DATA.WEIGHTED_SR.ENABLE = weighted
    c.DATA.WEIGHTED_SR.RANGES = [[2000, 8000], [8000, 12000], [12000, 16000]]
    c.EVAL_MODE = not training
    c.TAG = "8000_16000"
    return c


@pytest.mark.parametrize("kind", [("butter", 6), ("cheby1", 8), ("bessel", 12), ("ellip", 6)])
def test_lowpass_equal(kind, rng):
    x = rng.standard_normal(4000).astype(np.float32)
    got = degrade.lowpass(x, 4000, kind, 16000)
    np.testing.assert_array_equal(got, jax_degrade.lowpass(x, 4000, kind, 16000))
    assert got.dtype == np.float32


@pytest.mark.parametrize("sr_in", [16000, 8000, 11025, 2017])
@pytest.mark.parametrize("apply_lpf", [False, True])
def test_degrade_equal(sr_in, apply_lpf, rng):
    y = rng.standard_normal(2016).astype(np.float32) * 0.3
    x, hc = degrade.degrade(y, 16000, sr_in, ("cheby1", 6), 128, apply_lpf=apply_lpf)
    jx, jhc = jax_degrade.degrade(y, 16000, sr_in, ("cheby1", 6), 128, apply_lpf=apply_lpf)
    assert hc == jhc and x.shape == y.shape
    np.testing.assert_array_equal(x, jx)


def test_align_waveform_equal(rng):
    y = rng.standard_normal(100)
    for n in (60, 100, 140):
        r = rng.standard_normal(n)
        np.testing.assert_array_equal(degrade.align_waveform(r, y),
                                      jax_degrade.align_waveform(r, y))


@pytest.mark.parametrize("n,split", [(16, 0.25), (101, 0.1), (24, 0.2)])
def test_train_valid_split_equal(n, split):
    assert pipeline.train_valid_split(n, split) == jax_pipeline.train_valid_split(n, split)


def test_silence_labels_and_trim_equal(tmp_path, rng):
    labels = tmp_path / "silences.txt"
    labels.write_text("p225_001 0.125 0.5\np226_002 0.0 0.25\nbad line\n")
    table = vctk.parse_silence_labels(str(labels))
    assert table == jax_vctk.parse_silence_labels(str(labels))
    audio = rng.standard_normal(16000).astype(np.float32)
    for bounds in (table["p225_001"], table["p226_002"], None, (0.9, 5.0)):
        np.testing.assert_array_equal(vctk.trim_silence(audio, 16000, bounds),
                                      jax_vctk.trim_silence(audio, 16000, bounds))


@pytest.fixture
def corpus(tmp_path, rng):
    """A trimmed corpus: 5 speakers × 3 utterances × 2 mic-tagged files,
    plus untagged files for one speaker (the converted layout)."""
    root = tmp_path / "wav48_silence_trimmed_wav"
    for s in range(5):
        spk = f"p{225 + s}"
        d = root / spk
        d.mkdir(parents=True)
        for u in range(3):
            for mic in ("mic1", "mic2"):
                wav = rng.standard_normal(1600).astype(np.float32) * 0.1
                vctk.save_wav(str(d / f"{spk}_{u:03d}_{mic}.wav"), wav, 16000)
        if s == 4:
            vctk.save_wav(str(d / f"{spk}_{9:03d}.wav"), wav, 16000)
    return str(root)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("mic", ["mic1", "mic2"])
@pytest.mark.parametrize("quantity", [1.0, 0.5])
def test_vctk_dataset_same_ids(corpus, tmp_path, training, mic, quantity):
    kw = dict(training=training, mic_id=mic, train_split=(3, 2), use_quantity=quantity,
              seed=7)
    port = vctk.VCTKDataset(corpus, cache_path=str(tmp_path / "port.json"), **kw)
    ref = jax_vctk.VCTKDataset(corpus, cache_path=str(tmp_path / "jax.json"), **kw)
    ids = [(s.speaker_id, s.utterance_id, s.path) for s in port.samples]
    assert ids and ids == [(s.speaker_id, s.utterance_id, s.path) for s in ref.samples]
    # Again from the sample-id cache.
    again = vctk.VCTKDataset(corpus, cache_path=str(tmp_path / "port.json"), **kw)
    assert [(s.speaker_id, s.utterance_id, s.path) for s in again.samples] == ids
    for i in range(len(port)):
        a, sr, name = port.load(i)
        b, jsr, jname = ref.load(i)
        assert (sr, name) == (jsr, jname)
        np.testing.assert_array_equal(a, b)


def test_missing_corpus_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="SyntheticVCTK"):
        vctk.VCTKDataset(str(tmp_path / "nope"))


@pytest.mark.parametrize("training", [True, False])
def test_synthetic_vctk_bitwise(training):
    port = vctk.SyntheticVCTK(n_items=3, sr=16000, duration=0.2, seed=5, training=training)
    ref = jax_vctk.SyntheticVCTK(n_items=3, sr=16000, duration=0.2, seed=5, training=training)
    assert len(port) == len(ref) == 3
    for i in (0, 2, 0):  # the repeat comes from the memo
        a, sr, name = port.load(i)
        b, jsr, jname = ref.load(i)
        assert (sr, name) == (jsr, jname) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for field in ("wave_input", "wave_target", "highcut", "pad_lengths"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert g.names == w.names


@pytest.mark.parametrize("weighted", [False, True])
def test_train_loaders_bitwise_over_two_epochs(weighted):
    """get_loaders in training mode: the train (shuffled) and valid
    pipelines give the JAX package's batches bit for bit, epochs 0 and 1."""
    cfg = _tiny(default_config(), weighted=weighted)
    jcfg = _tiny(jax_default_config(), weighted=weighted)
    kw = dict(n_items=13, sr=16000, duration=0.15)
    train, valid = pipeline.get_loaders(cfg, dataset=vctk.SyntheticVCTK(**kw))
    jtrain, jvalid = jax_pipeline.get_loaders(jcfg, dataset=jax_vctk.SyntheticVCTK(**kw))
    assert (len(train), len(valid)) == (len(jtrain), len(jvalid)) == (3, 1)
    for epoch in (0, 1):
        for port, ref in ((train, jtrain), (valid, jvalid)):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            _assert_batches_equal(list(port), list(ref))
    train.set_epoch(0)
    b0 = [b.names for b in train]
    train.set_epoch(1)
    assert b0 != [b.names for b in train], "the shuffle should change with the epoch"


def test_eval_loader_bitwise():
    """get_loaders in eval mode: batch 1, in order, clips padded to a
    segment multiple, the input rate from the TAG."""
    cfg = _tiny(default_config(), training=False)
    jcfg = _tiny(jax_default_config(), training=False)
    kw = dict(n_items=3, sr=16000, duration=0.3, training=False)
    port = pipeline.get_loaders(cfg, dataset=vctk.SyntheticVCTK(**kw))
    ref = jax_pipeline.get_loaders(jcfg, dataset=jax_vctk.SyntheticVCTK(**kw))
    got = list(port)
    _assert_batches_equal(got, list(ref))
    assert all(b.wave_input.shape == (1, 1, 3 * 2016) for b in got)
    assert all(int(b.highcut[0]) == 32 for b in got)


def test_resampled_corpus_bitwise(corpus):
    """A 16 kHz corpus into a 48 kHz pipeline: items resampled on load."""
    cfg = _tiny(default_config())
    jcfg = _tiny(jax_default_config())
    for c in (cfg, jcfg):
        c.DATA.TARGET_SR = 48000
        c.DATA.RANDOM_RESAMPLE = [8000, 48000]
        c.DATA.SEGMENT = 0.05
    ds = vctk.VCTKDataset(corpus, train_split=(5, 0))
    jds = jax_vctk.VCTKDataset(corpus, train_split=(5, 0))
    sampler = pipeline.DegradingSampler(ds, cfg, training=True)
    jsampler = jax_pipeline.DegradingSampler(jds, jcfg, training=True)
    port = pipeline.DataPipeline(sampler, batch_size=4, num_workers=3, seed=9)
    ref = jax_pipeline.DataPipeline(jsampler, batch_size=4, num_workers=3, seed=9)
    _assert_batches_equal(list(port), list(ref))


def test_batch_to_device_cpu():
    b = pipeline.Batch(wave_input=np.ones((2, 1, 8), np.float32),
                       wave_target=np.zeros((2, 1, 8), np.float32),
                       highcut=np.array([3, 4], np.int32), names=["a", "b"],
                       pad_lengths=np.zeros(2, np.int32))
    out = pipeline.batch_to_device(b, "cpu")
    assert set(out) == {"wave_input", "wave_target", "highcut"}
    assert out["wave_input"].dtype == torch.float32 and out["highcut"].dtype == torch.int64
    assert out["highcut"].tolist() == [3, 4]
    assert torch.equal(out["wave_input"], torch.ones(2, 1, 8))


def test_get_loaders_without_a_corpus_fails(tmp_path):
    """Neither the trimmed wav tree nor the raw FLAC tree: the dataset
    raises, as the JAX package's does, and no marker is written."""
    cfg = _tiny(default_config())
    jcfg = _tiny(jax_default_config())
    cfg.DATA.DATA_PATH = jcfg.DATA.DATA_PATH = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="SyntheticVCTK") as port:
        pipeline.get_loaders(cfg)
    with pytest.raises(FileNotFoundError) as ref:
        jax_pipeline.get_loaders(jcfg)
    root = f"{tmp_path}/VCTK-Corpus-0.92/wav48_silence_trimmed_wav."
    assert str(port.value).startswith(f"VCTK corpus not found at {root}")
    assert str(ref.value).startswith(f"VCTK corpus not found at {root}")
    assert list(tmp_path.iterdir()) == []


def test_get_loaders_converts_a_raw_corpus(tmp_path):
    """Only the raw FLAC tree: get_loaders converts it, writes the marker,
    and reads the converted tree; a second call finds the tree and converts
    nothing."""
    from tests.test_torch_corpus import build_flac_corpus

    data_path, labels = build_flac_corpus(tmp_path / "data", utterances=2, seconds=0.3)
    cfg = _tiny(default_config())
    cfg.DATA.DATA_PATH, cfg.DATA.FLAC2WAV.TIMESTAMPS = data_path, labels
    cfg.DATA.TRAIN_SPLIT = [2, 1]
    cfg.DATA.USE_QUANTITY = 1.0
    train, valid = pipeline.get_loaders(cfg)
    root = tmp_path / "data" / "VCTK-Corpus-0.92" / "wav48_silence_trimmed_wav"
    assert (tmp_path / "data" / "VCTK-Corpus-0.92" / "wav48_silence_trimmed_wav.converted"
            ).read_text() == "ok\n"
    assert sorted(p.name for p in root.iterdir()) == ["p225", "p226", "p227"]
    assert len(train.indices) + len(valid.indices) == 4  # two speakers of two
    stamp = (root / "p225" / "p225_001.wav").stat().st_mtime_ns
    pipeline.get_loaders(cfg)
    assert (root / "p225" / "p225_001.wav").stat().st_mtime_ns == stamp


def test_get_loaders_other_ranks_wait_for_the_marker(tmp_path, monkeypatch):
    """A rank other than 0 converts nothing: it waits for rank 0's marker."""
    from tests.test_torch_corpus import build_flac_corpus

    data_path, labels = build_flac_corpus(tmp_path / "data", utterances=1, seconds=0.3)
    cfg = _tiny(default_config())
    cfg.DATA.DATA_PATH, cfg.DATA.FLAC2WAV.TIMESTAMPS = data_path, labels
    root = tmp_path / "data" / "VCTK-Corpus-0.92" / "wav48_silence_trimmed_wav"
    monkeypatch.setattr(pipeline, "process_rank", lambda: 1)
    slept = []

    def sleep(s):  # rank 0 "finishes" while rank 1 waits
        slept.append(s)
        root.mkdir(parents=True, exist_ok=True)
        Path(str(root) + ".converted").write_text("ok\n")

    monkeypatch.setattr(pipeline.time, "sleep", sleep)
    assert pipeline.ensure_wav_tree(cfg) == str(root)
    assert slept == [5.0] and list(root.iterdir()) == []


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_get_loaders_pipeline_grain(mode):
    """DATA.PIPELINE grain gives worker pipelines whose batches are bitwise
    the threads pipelines' (and so the JAX package's DataPipeline's)."""
    training = mode == "train"
    cfg = _tiny(default_config(), training=training)
    threads_cfg = _tiny(default_config(), training=training)
    cfg.DATA.PIPELINE = "grain"
    kw = dict(n_items=13, sr=16000, duration=0.3, training=training)
    got = pipeline.get_loaders(cfg, dataset=vctk.SyntheticVCTK(**kw))
    want = pipeline.get_loaders(threads_cfg, dataset=vctk.SyntheticVCTK(**kw))
    got, want = (got, want) if training else ((got,), (want,))
    for g, w in zip(got, want):
        assert isinstance(g, WorkerPipeline) and g.num_workers == 2
        assert len(g) == len(w) > 0
        _assert_batches_equal(list(g), list(w))


def test_pipeline_raises_a_worker_error():
    """A sample that fails in a pipeline thread is raised to the consumer,
    which does not wait forever."""
    class Broken(vctk.SyntheticVCTK):
        def load(self, i):
            if i == 5:
                raise ValueError("bad item")
            return super().load(i)

    cfg = _tiny(default_config())
    sampler = pipeline.DegradingSampler(Broken(n_items=9, sr=16000, duration=0.15), cfg)
    pipe = pipeline.DataPipeline(sampler, batch_size=2, shuffle=False, num_workers=2)
    result = {}

    def consume():
        try:
            result["n"] = sum(1 for _ in pipe)
        except ValueError as e:
            result["error"] = str(e)

    t = threading.Thread(target=consume)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and result == {"error": "bad item"}


def test_pipeline_holds_a_bounded_number_of_batches():
    """A consumer slower than the workers: while it holds batch k, no more
    than num_workers + prefetch batches from k on have been started, over an
    epoch ten times that long (so a long epoch cannot pile batches up in
    host memory)."""
    loads, lock = [0], threading.Lock()

    class Counting(vctk.SyntheticVCTK):
        def load(self, i):
            with lock:
                loads[0] += 1
            return super().load(i)

    cfg = _tiny(default_config())
    sampler = pipeline.DegradingSampler(Counting(n_items=80, sr=16000, duration=0.05), cfg)
    pipe = pipeline.DataPipeline(sampler, batch_size=2, shuffle=False, num_workers=2,
                                 prefetch=2)
    window = pipe.num_workers + pipe.prefetch
    ahead = []
    for k, _ in enumerate(pipe):
        time.sleep(0.02)
        with lock:
            ahead.append(-(-loads[0] // 2) - k)
    assert len(ahead) == 40 and loads[0] == 80
    assert max(ahead) <= window, ahead
