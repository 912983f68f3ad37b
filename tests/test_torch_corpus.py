"""From the raw VCTK 0.92 FLAC corpus to batches, the port against the JAX
package on the CPU: ``convert_flac_corpus`` writes the same wav files byte
for byte, and ``get_loaders`` on a raw tree converts it and then gives the
JAX package's batches bit for bit over two epochs, in training and in eval.

The corpus is a tiny tree laid out as tests/test_raw_corpus_e2e.py lays it
out (three speakers, and p280, which the conversion skips), encoded by the
pure-Python FLAC encoder of tests/flac_ref.py. Both packages decode,
filter and resample with the same C++ library (tests/torch_native.py).
"""

import os
from pathlib import Path

import numpy as np
import pytest

from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.data import pipeline as jax_pipeline
from vm_asr_tpu.data import vctk as jax_vctk
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.data import EXCLUDED_SPEAKERS, convert_flac_corpus, load_wav, pipeline
from tests.flac_ref import encode_flac
from tests.torch_native import jax_uses_port_native  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

SR = 48000
SPEAKERS = ("p225", "p226", "p227", "p280")


def build_flac_corpus(data_path: Path, utterances: int = 2, seconds: float = 0.4,
                      speakers=SPEAKERS):
    """``data_path/VCTK-Corpus-0.92/wav48_silence_trimmed/{spk}/{spk}_{utt}_mic1.flac``
    (and a mic2 file that the conversion ignores) with a silence-labels
    file beside the tree; returns (DATA_PATH, labels path)."""
    rng = np.random.default_rng(3)
    flac_root = data_path / "VCTK-Corpus-0.92" / "wav48_silence_trimmed"
    rows = []
    for s, spk in enumerate(speakers):
        d = flac_root / spk
        d.mkdir(parents=True)
        for u in range(1, utterances + 1):
            t = np.arange(int(SR * seconds)) / SR
            f0 = 150.0 + 37.0 * (u + s)
            sig = sum(np.sin(2 * np.pi * f0 * k * t + k) / k for k in range(1, 60)
                      if f0 * k < SR / 2)
            sig = sig + 0.05 * rng.standard_normal(t.shape)
            wav = (sig / np.abs(sig).max() * 12000).astype(np.int64)
            mode = "fixed1" if u == 1 else "verbatim"
            blob = encode_flac(wav[None, :], SR, mode=mode, blocksize=4096, rice_param=9)
            (d / f"{spk}_{u:03d}_mic1.flac").write_bytes(blob)
            rows.append(f"{spk}_{u:03d} 0.05 {seconds - 0.05:.2f}\n")
        (d / f"{spk}_001_mic2.flac").write_bytes(blob)
    (data_path / "vctk-silences.0.92.txt").write_text("".join(rows))
    return str(data_path) + "/", str(data_path / "vctk-silences.0.92.txt")


def _tree(root: Path):
    """{relative path: bytes} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data = tmp_path_factory.mktemp("corpus")
    return build_flac_corpus(data)


def test_convert_matches_jax(corpus, tmp_path):
    data_path, labels = corpus
    flac_root = os.path.join(data_path, "VCTK-Corpus-0.92", "wav48_silence_trimmed")
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert convert_flac_corpus(flac_root, str(port), labels) == 6
    assert jax_vctk.convert_flac_corpus(flac_root, str(ref), labels) == 6
    got = _tree(port)
    assert got == _tree(ref)
    assert sorted(got) == [f"{spk}/{spk}_{u:03d}.wav" for spk in ("p225", "p226", "p227")
                           for u in (1, 2)]
    assert EXCLUDED_SPEAKERS == jax_vctk.EXCLUDED_SPEAKERS == ("p280", "p315")
    # Trimmed to the label window [0.05, 0.35] s.
    wav, sr = load_wav(str(port / "p225" / "p225_001.wav"))
    assert sr == SR and wav.shape == (int(0.35 * SR) - int(0.05 * SR),)

    # Existing files are kept ...
    victim = port / "p226" / "p226_002.wav"
    victim.write_bytes(b"stale")
    (port / "p227" / "p227_001.wav").unlink()
    assert convert_flac_corpus(flac_root, str(port), labels) == 1
    assert victim.read_bytes() == b"stale"
    # ... unless overwrite, which rewrites every file as the JAX package does.
    assert convert_flac_corpus(flac_root, str(port), labels, overwrite=True) == 6
    assert jax_vctk.convert_flac_corpus(flac_root, str(ref), labels, overwrite=True) == 6
    assert _tree(port) == _tree(ref) == got
    assert not list(port.rglob("*.tmp*"))


def _tiny(c, data_path, labels, training=True):
    c.DATA.DATA_PATH = data_path
    c.DATA.FLAC2WAV.TIMESTAMPS = labels
    c.DATA.TRAIN_SPLIT = [2, 1]
    c.DATA.USE_QUANTITY = 1.0
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = 0.126
    c.DATA.STFT.N_FFT = 128
    c.DATA.RANDOM_RESAMPLE = [2000, 16000]
    c.DATA.BATCH_SIZE = 2
    c.DATA.NUM_WORKERS = 2
    c.DATA.VALID_SPLIT = 0.5
    c.EVAL_MODE = not training
    c.TAG = "8000_16000"
    return c


def _copy_corpus(corpus, dst: Path):
    """A copy of the raw tree and labels under ``dst``, for one package to
    convert on its own."""
    import shutil

    data_path, labels = corpus
    shutil.copytree(data_path, dst)
    return str(dst) + "/", str(dst / Path(labels).name)


@pytest.mark.parametrize("pipeline_name", ["threads", "grain"])
def test_get_loaders_from_raw_tree_bitwise_jax(corpus, tmp_path, pipeline_name):
    """Each package converts its own copy of the raw tree through
    get_loaders; the port's batches (threads or worker pipeline) equal the
    JAX threads pipeline's, train and valid, epochs 0 and 1, then eval."""
    port_data, port_labels = _copy_corpus(corpus, tmp_path / "port")
    jax_data, jax_labels = _copy_corpus(corpus, tmp_path / "jax")
    cfg = _tiny(default_config(), port_data, port_labels)
    cfg.DATA.PIPELINE = pipeline_name
    jcfg = _tiny(jax_default_config(), jax_data, jax_labels)
    train, valid = pipeline.get_loaders(cfg)
    jtrain, jvalid = jax_pipeline.get_loaders(jcfg)
    for data in (tmp_path / "port", tmp_path / "jax"):
        assert (data / "VCTK-Corpus-0.92" / "wav48_silence_trimmed_wav.converted").is_file()
    assert _tree(tmp_path / "port" / "VCTK-Corpus-0.92" / "wav48_silence_trimmed_wav") == \
        _tree(tmp_path / "jax" / "VCTK-Corpus-0.92" / "wav48_silence_trimmed_wav")
    assert (len(train), len(valid)) == (len(jtrain), len(jvalid)) == (1, 1)
    for epoch in (0, 1):
        for port, ref in ((train, jtrain), (valid, jvalid)):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            _assert_batches_equal(list(port), list(ref))

    ecfg = _tiny(default_config(), port_data, port_labels, training=False)
    ecfg.DATA.PIPELINE = pipeline_name
    test = pipeline.get_loaders(ecfg)
    jtest = jax_pipeline.get_loaders(_tiny(jax_default_config(), jax_data, jax_labels,
                                           training=False))
    got = list(test)
    assert [b.names for b in got] == [["p227_001.wav"], ["p227_002.wav"]]
    _assert_batches_equal(got, list(jtest))


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for field in ("wave_input", "wave_target", "highcut", "pad_lengths"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert g.names == w.names
