"""The port's model (vm_asr_tpu_torch.models) against the JAX package's, on
the CPU: JAX-initialised params carried across by flax_params_to_state_dict
and load_state_dict(strict=True), the same numpy inputs through both."""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu.compat.torch_port import state_dict_to_flax
from vm_asr_tpu.dsp import spectro2wav as jax_spectro2wav
from vm_asr_tpu.dsp import wav2spectro as jax_wav2spectro
from vm_asr_tpu.models import SS2D as JaxSS2D
from vm_asr_tpu.models import DualStreamInteractiveMambaUNet as JaxDual
from vm_asr_tpu.models import VSSBlock as JaxVSSBlock
from vm_asr_tpu.models import unet as jax_unet
from vm_asr_tpu_torch.compat import flax_params_to_state_dict, load_reference_checkpoint
from vm_asr_tpu_torch.dsp import spectro2wav, wav2spectro
from vm_asr_tpu_torch.models import SS2D, DualStreamInteractiveMambaUNet, VSSBlock
from vm_asr_tpu_torch.models import unet as torch_unet

# fp32: both sides compute the same float32 maths in other orders (matmul
# blocking, scan association, FFT); the observed gap is ~4e-6 of the output
# scale, so 1e-4 of it leaves room without hiding a wiring fault, which moves
# the output by O(1).
FP32_REL = 1e-4

# dims 16: below it the v3 head's LayerNorms act over < 8 channels and
# collapse toward constants, which would blind the comparison
# (vm_asr_tpu/models/unet.py:30-35). n_fft 64, hop 16: a 32×32 image.
SMALL = dict(dims=16, depths=(1, 1, 1, 1), n_fft=64, hop_length=16, win_length=64)
T = 31 * 16


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _rel(got, ref):
    return np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32)).max() \
        / np.abs(np.asarray(ref, np.float32)).max()


def _wave(rng, batch, t, n_fft):
    """Random waveform with the Nyquist offset and zeroed boundaries of
    vm_asr_tpu/compat/parity_check.py:147-160: without them, angle() of the
    exactly-real Nyquist and boundary bins flips by 2π between the two FFTs."""
    x = rng.standard_normal((batch, 1, t))
    x = x + (np.abs(x).max() + 1.0) * (-1.0) ** np.arange(t)
    x[..., :n_fft] = 0.0
    x[..., -n_fft:] = 0.0
    return x.astype(np.float32)


def test_ss2d_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)  # H ≠ W
    jm = JaxSS2D(d_model=16, scan_impl="ref")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(x))
    m = SS2D(d_model=16)
    m.load_state_dict(flax_params_to_state_dict(_np_tree(params)), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert _rel(got, ref) < FP32_REL


def test_vss_block_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 16, 8, 16)).astype(np.float32)
    jm = JaxVSSBlock(hidden_dim=16, scan_impl="ref")
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(x))
    m = VSSBlock(16)
    m.load_state_dict(flax_params_to_state_dict(_np_tree(params)), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert _rel(got, ref) < FP32_REL


@pytest.fixture(scope="module")
def dual():
    """JAX params of the small dual-stream model, its input, and the JAX
    outputs in fp32 and bf16 compute (one init: params are fp32 in both)."""
    x = _wave(np.random.default_rng(2), 2, T, SMALL["n_fft"])
    hf = np.array([10, 11])
    jm = JaxDual(scan_impl="ref", **SMALL)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(hf))["params"]
    outs = {}
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        model = JaxDual(scan_impl="ref", dtype=dt, **SMALL)
        outs[name] = np.asarray(
            jax.jit(model.apply)({"params": params}, jnp.asarray(x), jnp.asarray(hf)))
    return _np_tree(params), x, hf, outs


def _port_forward(params, x, hf, compute_dtype):
    m = DualStreamInteractiveMambaUNet(compute_dtype=compute_dtype, **SMALL).eval()
    m.load_state_dict(flax_params_to_state_dict(params), strict=True)
    with torch.inference_mode():
        return m(torch.from_numpy(x), torch.from_numpy(hf)).numpy()


def test_dual_stream_fp32_matches_jax(dual):
    params, x, hf, outs = dual
    got = _port_forward(params, x, hf, torch.float32)
    assert got.shape == x.shape
    assert _rel(got, outs["float32"]) < FP32_REL


def test_dual_stream_bf16_matches_jax(dual):
    """bf16 compute rounds at different places in the two frameworks (flax
    runs the depthwise conv as nine bf16 multiply-adds, cuDNN/torch sum in
    fp32; GELU and SiLU round once here, per op there), so the two bf16
    outputs differ by bf16 noise through a deep network, not by 1e-4. The
    bar: the port's bf16 output is no farther from JAX's bf16 output than
    JAX's own bf16 output is from its fp32 output, twice over."""
    params, x, hf, outs = dual
    got = _port_forward(params, x, hf, torch.bfloat16)
    assert np.isfinite(got).all()
    bf16_noise = _rel(outs["bfloat16"], outs["float32"])
    assert 0 < bf16_noise < 0.2
    assert _rel(got, outs["bfloat16"]) <= 2 * bf16_noise


def test_flax_state_dict_round_trip(dual):
    """flax_params_to_state_dict inverts state_dict_to_flax."""
    params = dual[0]
    back = state_dict_to_flax(flax_params_to_state_dict(params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


@pytest.mark.parametrize("fix,expected", [(False, 2_246_064), (True, 3_010_352)])
def test_flagship_param_count(fix, expected):
    """The JAX package's counts (tests/test_models.py): without the phase
    decoder fix the phase decoders are dead weights and are not built."""
    with torch.device("meta"):
        m = DualStreamInteractiveMambaUNet(phase_decoder_fix=fix, dims=16,
                                           depths=(2, 2, 2, 2))
    assert sum(p.numel() for p in m.parameters()) == expected
    assert any(k.startswith("layers_decoder_phase.") for k in m.state_dict()) == fix


@pytest.mark.parametrize("extra", ["epoch", "pickled_object"])
def test_reference_checkpoint_drops_phase_decoders(tmp_path, extra):
    """A reference checkpoint loads by name, its dead phase decoders dropped.
    One that pickles a non-tensor object (the reference stores its config)
    is refused by the weights-only loader and read in full, with a warning."""
    full = DualStreamInteractiveMambaUNet(phase_decoder_fix=True, **SMALL)
    sd = {k: torch.randn(v.shape) for k, v in full.state_dict().items()}
    path = tmp_path / "checkpoint-best-G.pth"
    blob = {"state_dict": sd, "epoch": 3}
    if extra == "pickled_object":
        blob["config"] = argparse.Namespace(seed=0)
    torch.save(blob, path)
    m = DualStreamInteractiveMambaUNet(**SMALL)
    if extra == "pickled_object":
        with pytest.warns(UserWarning, match="full unpickling"):
            load_reference_checkpoint(m, str(path))
    else:
        load_reference_checkpoint(m, str(path))
    for k, v in m.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["torch", "fixed"])
def test_low_freq_replacement_matches_jax(mode):
    rng = np.random.default_rng(3)
    out, orig = rng.standard_normal((2, 2, 20, 7)).astype(np.float32)
    hf = np.array([5, 12])
    fn_t = {"torch": torch_unet._low_freq_replacement_torch_2d,
            "fixed": torch_unet._low_freq_replacement}[mode]
    fn_j = {"torch": jax_unet._low_freq_replacement_torch_2d,
            "fixed": jax_unet._low_freq_replacement}[mode]
    np.testing.assert_array_equal(
        fn_t(torch.from_numpy(out), torch.from_numpy(orig), torch.from_numpy(hf)).numpy(),
        np.asarray(fn_j(jnp.asarray(out), jnp.asarray(orig), jnp.asarray(hf))))


@pytest.mark.parametrize("scale", ["log2", "dB"])
def test_stft_front_end_matches_jax(scale):
    """wav2spectro / spectro2wav (torch.stft / istft) against the JAX
    package's own STFT; phase compared where both FFTs give the same branch
    (the _wave trick keeps angle() off the ±π cut)."""
    x = _wave(np.random.default_rng(4), 2, T, 64)[:, 0]
    mag, phase = wav2spectro(torch.from_numpy(x), 64, 16, 64, scale)
    mag_j, phase_j = jax_wav2spectro(jnp.asarray(x), 64, 16, 64, scale)
    assert mag.shape == (2, 33, T // 16 + 1)
    np.testing.assert_allclose(mag.numpy(), np.asarray(mag_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(phase.numpy(), np.asarray(phase_j), rtol=1e-4, atol=1e-4)
    wav = spectro2wav(mag, phase, 64, 16, 64, scale).numpy()
    wav_j = np.asarray(jax_spectro2wav(mag_j, phase_j, 64, 16, 64, scale))
    np.testing.assert_allclose(wav, wav_j, rtol=1e-4, atol=1e-4 * np.abs(wav_j).max())


def test_ss2d_init_ranges():
    """The port's init gives the JAX package's decay range: softplus(dt_bias)
    in [dt_min, dt_max], A = -1 (A_logs = log 1 at N = 1), D = 1."""
    from vm_asr_tpu_torch.models import init_parameters

    m = SS2D(d_model=32)
    init_parameters(m, torch.Generator().manual_seed(0))
    dt = torch.nn.functional.softplus(m.dt_projs_bias.detach())
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)
    assert torch.equal(m.A_logs.detach(), torch.zeros_like(m.A_logs))
    assert torch.equal(m.Ds.detach(), torch.ones_like(m.Ds))
    jm = JaxSS2D(d_model=32, scan_impl="ref")
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 32)))["params"]
    jdt = np.asarray(jax.nn.softplus(jp["dt_projs_bias"]))
    assert jdt.min() >= 1e-3 * (1 - 1e-5) and jdt.max() <= 0.1 * (1 + 1e-5)
    assert m.x_proj_weight.abs().max() <= 1 / np.sqrt(64)
    assert np.abs(np.asarray(jp["x_proj_weight"])).max() <= 1 / np.sqrt(64)
