"""The port's serving path (segmentation, bucketing, Inferencer) against the
JAX package's, on the CPU."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vm_asr_tpu.compat.torch_port import state_dict_to_flax
from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.core import load_config as jax_load_config
from vm_asr_tpu.dsp import fold_audio as jax_fold
from vm_asr_tpu.dsp import unfold_audio as jax_unfold
from vm_asr_tpu.models import get_model
from vm_asr_tpu.train import steps as jax_steps
from vm_asr_tpu.train.inferencer import Inferencer as JaxInferencer
from vm_asr_tpu_torch import cli
from vm_asr_tpu_torch.core import default_config, load_config
from vm_asr_tpu_torch.dsp import fold_audio, load_wav, num_segments, save_wav, unfold_audio
from vm_asr_tpu_torch.models import get_generator
from vm_asr_tpu_torch.train import Inferencer, bucketed_forward, segment_bucket_counts

# Same fp32 bar as tests/test_torch_model.py: same maths, other orders.
FP32_REL = 1e-4
ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (ROOT / "configs").glob("*.yaml"))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_jax(name):
    """The port's copy of the config schema parses every shipped config to
    the same tree as the JAX package's."""
    opts = ["DATA.BATCH_SIZE", "3", "MODEL.VSSM.DEPTHS", "[1, 1, 1, 1]"]
    got = load_config(str(ROOT / "configs" / name), opts).to_dict()
    assert got == jax_load_config(str(ROOT / "configs" / name), opts).to_dict()


@pytest.mark.parametrize("t", [100, 190, 250, 377, 1000])
def test_unfold_fold_match_jax(t):
    seg, overlap = 100, 10
    x = np.random.default_rng(t).standard_normal((1, 1, t)).astype(np.float32)
    segs = unfold_audio(torch.from_numpy(x), seg, overlap)
    segs_j = jax_unfold(jnp.asarray(x), seg, overlap)
    assert segs.shape[-2] == num_segments(t, seg, overlap)
    np.testing.assert_array_equal(segs.numpy(), np.asarray(segs_j))
    y = np.random.default_rng(1).standard_normal(segs.shape).astype(np.float32)
    np.testing.assert_allclose(
        fold_audio(torch.from_numpy(y), t, seg, overlap).numpy(),
        np.asarray(jax_fold(jnp.asarray(y), t, seg, overlap)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s", [1, 2, 3, 5, 8, 11, 16, 23])
def test_bucketed_forward_matches_jax(s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((s, 1, 32)).astype(np.float32)
    hf = rng.integers(1, 60, (s,)).astype(np.int32)
    sizes = []

    def fwd(xb, hb):
        sizes.append(xb.shape[0])
        return xb * 2.0 + hb[:, None, None].to(xb.dtype)

    got = bucketed_forward(fwd, torch.from_numpy(x), torch.from_numpy(hf))
    want = jax_steps.bucketed_forward(
        lambda p, xb, hb: xb * p + hb[:, None, None].astype(xb.dtype),
        2.0, jnp.asarray(x), jnp.asarray(hf))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert segment_bucket_counts(s) == jax_steps.segment_bucket_counts(s)
    assert all(b in (1, 2, 4, 8) for b in sizes)


def _small(config):
    """16 kHz, n_fft 128, hop 32, one segment = 992 samples = 31 hops: a
    64×32 image, which the four stages divide. (At n_fft 256 the two FFTs
    give the all-zero boundary frames' bins +0 and -0 real parts, so angle()
    differs by π there and the phase streams see different inputs.)"""
    c = config
    c.MODEL.NAME = "DualStreamInteractiveMambaUNet"
    c.MODEL.VSSM.DIMS = 16
    c.MODEL.VSSM.DEPTHS = [1, 1, 1, 1]
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = 0.062
    c.DATA.STFT.N_FFT = 128
    c.DATA.STFT.WIN_LENGTH = 128
    c.DATA.STFT.HOP_LENGTH = 32
    c.AMP_ENABLE = False
    c.INFERENCE.OVERLAP = 100
    c.TAG = "8000_16000"
    c.TENSORBOARD.ENABLE = False
    return c


def test_inferencer_matches_jax(tmp_path):
    """One single-segment wav at the target rate, the same weights (the
    port's seeded init, carried to flax by state_dict_to_flax). The wav has
    the Nyquist offset and zeroed ends of tests/test_torch_model.py::_wave,
    in [-0.9, 0.9] so that 16-bit PCM keeps it."""
    c = _small(default_config())
    cj = _small(jax_default_config())
    c.OUTPUT = cj.OUTPUT = str(tmp_path / "logs")
    seg = int(c.DATA.SEGMENT * c.DATA.TARGET_SR)
    rng = np.random.default_rng(4)
    wav = rng.uniform(-0.3, 0.3, seg) + 0.6 * (-1.0) ** np.arange(seg)
    wav[:128] = 0.0
    wav[-128:] = 0.0
    path = str(tmp_path / "clip.wav")
    save_wav(path, wav, 16000)

    gen = get_generator(c, device="cpu", seed=7)
    params = state_dict_to_flax(gen.state_dict())
    jax_gen = get_model(cj)["generator"]

    got = Inferencer(c, gen, output_dir=str(tmp_path / "port"), device="cpu").infer_file(path)
    want = JaxInferencer(cj, jax_gen, params, output_dir=str(tmp_path / "jax")).infer_file(path)
    assert got.shape == (1, 1, seg)
    rel = np.abs(got.numpy() - np.asarray(want)).max() / np.abs(np.asarray(want)).max()
    assert rel < FP32_REL
    out, sr = load_wav(str(tmp_path / "port" / "clip_enhanced.wav"))
    assert sr == 16000 and out.shape == (seg,)


def test_inferencer_long_clip_cpu(tmp_path):
    """A clip of several segments takes unfold → bucketed forward → fold and
    comes back at its padded length, finite."""
    c = _small(default_config())
    c.OUTPUT = str(tmp_path / "logs")
    path = str(tmp_path / "long.wav")
    save_wav(path, np.random.default_rng(5).standard_normal(3000).astype(np.float32) * 0.1, 8000)
    inf = Inferencer(c, get_generator(c, device="cpu"), output_dir=str(tmp_path / "o"),
                     device="cpu")
    out = inf.infer_file(path)
    seg = inf.num_frames_per_seg
    assert out.shape[-1] % seg == 0 and out.shape[-1] >= 6000
    assert torch.isfinite(out).all()


def test_cli_inference_cpu_with_reference_checkpoint(tmp_path):
    """--inference --device cpu loads a reference-layout *best*G*.pth from
    --resume (phase decoders dropped) and writes the enhanced wav."""
    from vm_asr_tpu_torch.models import DualStreamInteractiveMambaUNet, init_parameters

    opts = ["MODEL.VSSM.DEPTHS", "[1, 1, 1, 1]", "DATA.STFT.N_FFT", "128",
            "DATA.STFT.WIN_LENGTH", "128", "DATA.SEGMENT", "0.155",  # 31 hops of 80
            "INFERENCE.RESULTS_DIR", str(tmp_path / "res")]
    run = tmp_path / "run"
    run.mkdir()
    ref = DualStreamInteractiveMambaUNet(phase_decoder_fix=True, depths=(1, 1, 1, 1),
                                         n_fft=128, win_length=128, hop_length=80)
    init_parameters(ref, torch.Generator().manual_seed(1))
    torch.save({"state_dict": ref.state_dict()}, run / "checkpoint-best-G.pth")
    wav = tmp_path / "in.wav"
    save_wav(str(wav), np.random.default_rng(6).standard_normal(2000).astype(np.float32) * 0.1,
             8000)
    assert cli.main(["--cfg", str(ROOT / "configs/vm_asr_16k.yaml"), "--inference",
                     "--tag", "8000_16000", "--input", str(wav), "--resume", str(run),
                     "--device", "cpu", "--opts", *opts]) == 0
    out, sr = load_wav(str(tmp_path / "res" / "DualStreamInteractiveMambaUNet" /
                           "in_enhanced.wav"))
    assert sr == 16000 and out.shape == (4960,) and 0 < np.abs(out).max() < 1
