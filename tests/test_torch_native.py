"""The port's host C++ library (vm_asr_tpu_torch/data/native.py) on the CPU:
the resampler and the zero-phase filter against scipy at the JAX package's
bars (tests/test_native.py) and bitwise against the JAX binding of the same
library, the PCM round trip, and the FLAC decoder over the matrix of
tests/test_flac.py, decoded bitwise to the PCM the pure-Python encoder
(tests/flac_ref.py) was given. Also the choice of path in dsp/: C++ for a
1-D signal (and at most 16 filter sections), scipy otherwise, and scipy's
error for a signal too short to filter.
"""

import importlib

import numpy as np
import pytest
from scipy.signal import bessel, cheby1, ellip, resample_poly, sosfiltfilt

from vm_asr_tpu.data import native as jax_native
from vm_asr_tpu_torch.data import native
from tests.flac_ref import encode_flac
from tests.torch_native import jax_uses_port_native  # noqa: F401

degrade = importlib.import_module("vm_asr_tpu_torch.dsp.degrade")
audio = importlib.import_module("vm_asr_tpu_torch.dsp.audio")

FILTERS = {
    "cheby1_6": cheby1(6, 0.05, 0.25, btype="lowpass", output="sos"),
    "cheby1_12": cheby1(12, 0.05, 0.6, btype="lowpass", output="sos"),
    "bessel_12": bessel(12, 0.3, norm="mag", btype="lowpass", output="sos"),
    "ellip_6": ellip(6, 0.05, 20, 0.4, btype="lowpass", output="sos"),
}


def test_library_is_built_once_and_reused():
    path = native.library_path()
    assert native.build() == 0.0 and path.is_file()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert native.load() is native.load()


@pytest.mark.parametrize("up,down", [(1, 3), (2, 3), (3, 1), (160, 441), (441, 160), (6, 1),
                                     (1, 6), (5, 5)])
def test_resample_poly(up, down, rng):
    x = rng.standard_normal(48000).astype(np.float32)
    got = native.resample_poly(x, up, down)
    want = resample_poly(x.astype(np.float64), up, down).astype(np.float32)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got, jax_native.resample_poly(x, up, down))


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_sosfiltfilt(name, rng):
    sos = FILTERS[name]
    x = rng.standard_normal(20000).astype(np.float32)
    got = native.sosfiltfilt(sos, x)
    want = sosfiltfilt(sos, x.astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(got, jax_native.sosfiltfilt(sos, x))


def test_pcm_roundtrip(rng):
    x = rng.uniform(-0.9, 0.9, 1000).astype(np.float32)
    pcm = native.f32_to_pcm16(x)
    back = native.pcm16_to_f32(pcm)
    # Encoded ×32767 and decoded ÷32768: ~2^-15 of systematic error plus rounding.
    np.testing.assert_allclose(back, x, atol=1.0 / 16000)
    np.testing.assert_array_equal(pcm, jax_native.f32_to_pcm16(x))
    np.testing.assert_array_equal(back, jax_native.pcm16_to_f32(pcm))
    np.testing.assert_array_equal(native.f32_to_pcm16(np.array([2.0, -2.0], np.float32)),
                                  [32767, -32767])


def test_dsp_takes_the_native_path(rng, monkeypatch):
    """resample_audio and lowpass of a 1-D signal are the library's results;
    a 2-D signal and a 17-section filter go to scipy."""
    x = rng.standard_normal(4800).astype(np.float32)
    np.testing.assert_array_equal(audio.resample_audio(x, 48000, 16000),
                                  native.resample_poly(x, 16000, 48000))
    two_d = np.stack([x, -x])
    np.testing.assert_array_equal(audio.resample_audio(two_d, 48000, 16000),
                                  resample_poly(two_d, 16000, 48000, axis=-1).astype(np.float32))
    sos = cheby1(8, 0.05, 8000 / 24000, btype="lowpass", output="sos")
    np.testing.assert_array_equal(degrade.lowpass(x, 8000, ("cheby1", 8), 48000),
                                  native.sosfiltfilt(sos, x))
    calls = []
    monkeypatch.setattr(native, "sosfiltfilt", lambda *a: calls.append(a))
    deep = degrade.lowpass(x, 8000, ("butter", 34), 48000)  # 17 sections: scipy
    assert not calls and deep.dtype == np.float32 and np.isfinite(deep).all()


def test_too_short_to_filter_raises_scipys_error():
    x = np.ones(20, np.float32)
    with pytest.raises(ValueError) as port:
        degrade.lowpass(x, 4000, ("cheby1", 8), 16000)
    jax_degrade = importlib.import_module("vm_asr_tpu.dsp.degrade")
    with pytest.raises(ValueError) as ref:
        jax_degrade.lowpass(x, 4000, ("cheby1", 8), 16000)
    assert str(port.value) == str(ref.value) and "padlen" in str(port.value)


# --- FLAC -------------------------------------------------------------------

def _signal(n, channels=1, seed=0, amp=12000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    base = amp * np.sin(2 * np.pi * 220.0 * t)
    out = np.stack([base + rng.normal(0, 500, n) * (c + 1) for c in range(channels)])
    return np.round(out).astype(np.int64)


def _roundtrip(samples, sr=48000, bps=16, **kw):
    blob = encode_flac(samples, sr, bps=bps, **kw)
    decoded, got_sr = native.decode_flac(blob)
    assert got_sr == sr and decoded.dtype == np.float32
    np.testing.assert_array_equal(decoded * float(1 << (bps - 1)), np.atleast_2d(samples))
    want, _ = jax_native.decode_flac(blob)
    np.testing.assert_array_equal(decoded, want)


@pytest.mark.parametrize("mode", ["verbatim", "fixed0", "fixed1", "fixed2", "fixed3", "fixed4",
                                  "lpc2", "lpc8"])
def test_flac_mono_subframe_modes(mode):
    _roundtrip(_signal(1000), mode=mode)


def test_flac_constant_subframe():
    _roundtrip(np.full((1, 512), -1234, np.int64), mode="constant")


@pytest.mark.parametrize("channel_mode", ["independent", "left_side", "mid_side"])
def test_flac_stereo_channel_modes(channel_mode):
    _roundtrip(_signal(800, channels=2), mode="fixed2", channel_mode=channel_mode)


@pytest.mark.parametrize("kw", [dict(partition_order=2, rice_param=6),
                                dict(partition_order=1, escape=True)])
def test_flac_rice_partitions_and_escape(kw):
    _roundtrip(_signal(1024), mode="fixed1", **kw)


def test_flac_tail_not_a_multiple_of_the_block():
    # 1000 samples in blocks of 256: the last block is padded, and the
    # decoder stops at STREAMINFO's total.
    _roundtrip(_signal(1000), mode="verbatim", blocksize=256)


def test_flac_24_bit():
    _roundtrip(_signal(600) * 64, bps=24, mode="fixed2")


def test_flac_from_a_path(tmp_path):
    s = _signal(700)
    (tmp_path / "a.flac").write_bytes(encode_flac(s, 44100, mode="fixed2"))
    decoded, sr = native.decode_flac(str(tmp_path / "a.flac"))
    assert sr == 44100
    np.testing.assert_array_equal(decoded * 32768.0, s)


def test_flac_corrupt_stream_rejected():
    with pytest.raises(ValueError, match="FLAC decode failed"):
        native.decode_flac(b"not a flac stream at all")


def test_flac_fuzz_does_not_crash():
    """Flipped bytes and junk either decode or raise ValueError; the decoder
    is bounds-checked, so the process survives."""
    rng = np.random.default_rng(0)
    good = encode_flac(_signal(400), 48000, mode="fixed2")
    outcomes = []
    for _ in range(200):
        blob = bytearray(good)
        for _ in range(rng.integers(1, 20)):
            blob[rng.integers(4, len(blob))] ^= int(rng.integers(1, 256))
        try:
            native.decode_flac(bytes(blob))
            outcomes.append("decoded")
        except ValueError:
            outcomes.append("rejected")
    for _ in range(50):
        junk = rng.integers(0, 256, size=rng.integers(1, 4000), dtype=np.uint8)
        with pytest.raises(ValueError):
            native.decode_flac(junk.tobytes())
    assert "rejected" in outcomes
