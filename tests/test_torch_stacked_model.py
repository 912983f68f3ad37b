"""The port's stream-stacked generator (DualStreamStackedMambaUNet,
stack_dual_state, to_stacked) on the CPU: against the port's unstacked
model, and against the JAX package's stacked model on weights carried
across (stack_dual_params), at the JAX tests' geometry (n_fft 128, hop 32,
2016 samples, depths 1-1-1-1)."""

import importlib
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu.compat.torch_port import state_dict_to_flax
from vm_asr_tpu.models.unet import DualStreamStackedMambaUNet as JaxStacked
from vm_asr_tpu.models.unet import stack_dual_params
from vm_asr_tpu_torch.compat import flax_params_to_state_dict
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.models import (
    DualStreamInteractiveMambaUNet,
    DualStreamStackedMambaUNet,
    get_generator,
    init_parameters,
    stack_dual_state,
    to_stacked,
)
from vm_asr_tpu_torch.ops import linear_recurrence, selective_scan_fused
from tests.torch_threads import one_torch_thread  # noqa: F401

GEOM = dict(n_fft=128, hop_length=32, win_length=128)
SEG = 2016  # a 64×64 spectral image after the DC drop
# The same fp32 maths on both sides but for the order of a few sums (the
# batched matmuls and grouped convs of vmap against their single-stream
# ops): the JAX package's own stacked-vs-unstacked bar
# (tests/test_stacked_dual.py), absolute.
STACKED_ABS = 1e-6
# Port against JAX on one set of weights: the two frameworks' fp32 forwards
# differ by rounding (FFT, matmul blocking, scan association): up to 1.5e-5
# of the output's scale at DIMS 8 for the unstacked forwards (PERF.md, PR
# 9), 3.0e-6 (production) and 7.8e-7 (latent) here. The bar is 1e-5 of the
# largest |output|; a wiring fault moves the output by O(1).
JAX_REL = 1e-5
# The cases of tests/test_stacked_dual.py:38-48: (model options, stacking
# options beyond concat_skip).
CASES = {
    "production": ({}, {}),
    "phase_decoder_fix": ({"phase_decoder_fix": True}, {"phase_decoder_fix": True}),
    "additive_skips": ({"concat_skip": False}, {}),
    "p2m": ({"interact": "p2m"}, {}),
    "latent": ({"dims": (4, 8, 16, 32, 64)}, {"has_latent": True}),
}
PERF_DROP = "There is a performance drop"  # functorch's per-stream-loop fallback


def _wave(batch, seed):
    """Random waveform with the Nyquist offset and zeroed boundaries of
    tests/test_torch_model.py (angle() of the exactly-real bins then agrees
    between the two FFTs)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 1, SEG))
    x = x + (np.abs(x).max() + 1.0) * (-1.0) ** np.arange(SEG)
    x[..., :128] = 0.0
    x[..., -128:] = 0.0
    return (0.1 * x).astype(np.float32)


def _pair(seed=0, dims=4, **kw):
    """A seeded unstacked model and its stacked twin (stack_dual_state)."""
    kwargs = dict(depths=(1, 1, 1, 1), dims=dims, **GEOM, **kw)
    stacking = {k: v for k, v in kwargs.items() if k in ("concat_skip", "phase_decoder_fix")}
    dual = DualStreamInteractiveMambaUNet(**kwargs)
    init_parameters(dual, torch.Generator().manual_seed(seed))
    with torch.device("meta"):
        stacked = DualStreamStackedMambaUNet(**kwargs)
    dims_ = kwargs["dims"]
    stacking["has_latent"] = not isinstance(dims_, int) and len(dims_) == 5
    stacked.load_state_dict(stack_dual_state(dual.state_dict(), **stacking), assign=True)
    return dual.eval(), stacked.eval()


def _run(model, x, hf):
    with torch.inference_mode(), warnings.catch_warnings():
        warnings.filterwarnings("error", message=PERF_DROP)
        return model(torch.from_numpy(x), torch.from_numpy(hf).long())


@pytest.mark.parametrize("case", sorted(CASES))
def test_stacked_matches_unstacked(case):
    """Each case of the JAX package's equivalence test, fp32, no
    per-stream loop anywhere in the vmapped stages."""
    kw, _ = CASES[case]
    dual, stacked = _pair(**kw)
    x, hf = _wave(2, 0), np.array([33, 20], np.int32)
    ref, got = _run(dual, x, hf), _run(stacked, x, hf)
    assert got.shape == ref.shape == (2, 1, SEG)
    assert float((got - ref).abs().max()) <= STACKED_ABS


@pytest.mark.parametrize("case", ["production", "latent"])
def test_stacked_matches_jax_stacked(case):
    """The port's stacked model against the JAX DualStreamStackedMambaUNet
    with stack_dual_params, on the port's seeded weights carried to flax
    (the JAX package's state_dict_to_flax), DIMS 8; and JAX params reach
    the stacked port as any JAX params would, through
    flax_params_to_state_dict and stack_dual_state."""
    kw, conv_kw = CASES[case]
    kw = dict(kw, dims=kw.get("dims", 8))
    dual, stacked = _pair(seed=3, **kw)
    params = state_dict_to_flax({k: v.numpy() for k, v in dual.state_dict().items()})
    carried = stack_dual_state(flax_params_to_state_dict(params), **conv_kw)
    own = stacked.state_dict()
    assert sorted(carried) == sorted(own) and all(torch.equal(carried[k], own[k]) for k in own)
    jax_model = JaxStacked(depths=(1, 1, 1, 1), **GEOM, **kw)
    x, hf = _wave(1, 7), np.array([33], np.int32)
    apply = jax.jit(jax_model.apply, static_argnames="deterministic")
    ref = np.asarray(apply({"params": stack_dual_params(params, **conv_kw)},
                           jnp.asarray(x), jnp.asarray(hf), deterministic=True))
    got = _run(stacked, x, hf).numpy()
    assert np.abs(got - ref).max() <= JAX_REL * np.abs(ref).max()


def test_stacked_state_layout():
    """Every stacked tensor is the unstacked one with a leading stream axis
    of 2, mag first; the concat-skip decoders past stage 0 stack [mag, mag]
    (the reference's phase-through-mag-decoder quirk); the phase decoders
    stack [mag, phase] with the fix."""
    dual, stacked = _pair()
    sd, st = dual.state_dict(), stacked.state_dict()
    mag = {k.replace("_mag.", ".", 1): v for k, v in sd.items() if "_mag." in k}
    assert sorted(st) == sorted(mag)
    for k, v in st.items():
        assert v.shape == (2, *mag[k].shape) and torch.equal(v[0], mag[k])
        other = v[1]
        if k.startswith("layers_decoder."):
            assert torch.equal(other, mag[k]), k
        else:
            assert torch.equal(other, sd[k.replace(".", "_phase.", 1)]), k
    fixed_dual, fixed = _pair(phase_decoder_fix=True)
    fsd = fixed_dual.state_dict()
    for k, v in fixed.state_dict().items():
        if k.startswith("layers_decoder."):
            assert torch.equal(v[1], fsd[k.replace(".", "_phase.", 1)]), k
    assert not any(p.requires_grad for p in stacked.parameters())


def test_single_interact_rejected():
    with pytest.raises(ValueError, match="single"):
        DualStreamStackedMambaUNet(interact="single", depths=(1, 1, 1, 1), dims=4, **GEOM)


def _config(**vssm):
    c = default_config()
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = SEG / 16000
    c.DATA.STFT.N_FFT = 128
    c.DATA.STFT.HOP_LENGTH = 32
    c.DATA.STFT.WIN_LENGTH = 128
    c.MODEL.NAME = "DualStreamInteractiveMambaUNet"
    c.MODEL.VSSM.DIMS = 4
    c.MODEL.VSSM.DEPTHS = [1, 1, 1, 1]
    c.MODEL.VSSM.STACKED_EXECUTION = True
    c.DTYPE.COMPUTE = "float32"
    c.AMP_ENABLE = False
    for key, value in vssm.items():
        if key == "NAME":
            c.MODEL.NAME = value
        else:
            c.MODEL.VSSM[key] = value
    return c


def test_to_stacked_roundtrip_and_no_ops():
    """to_stacked swaps the factory's model for its stacked twin with
    identical outputs, and is a no-op where the JAX one is: the option off,
    another model, interact "single", or a model stacked already."""
    c = _config()
    gen = get_generator(c, "cpu")
    assert isinstance(gen, DualStreamInteractiveMambaUNet)  # training keeps it unstacked
    stacked = to_stacked(c, gen)
    assert isinstance(stacked, DualStreamStackedMambaUNet) and not stacked.training
    x, hf = _wave(1, 3), np.array([33], np.int32)
    assert float((_run(stacked, x, hf) - _run(gen, x, hf)).abs().max()) <= STACKED_ABS
    assert to_stacked(c, stacked) is stacked
    for cfg in (_config(STACKED_EXECUTION=False), _config(INTERACT="single"),
                _config(NAME="MambaUNet")):
        g = get_generator(cfg, "cpu")
        assert to_stacked(cfg, g) is g


def test_scans_take_the_vmap_rules(monkeypatch):
    """At DIMS 16 each stream runs 8 SS2Ds on the fused route (4 encoder
    stages, 3 decoder stages, out_vss1) and 2 on the recurrence (out_vss2,
    out_vss3): the stacked forward calls each scan's batching rule once per
    pair, 8 + 2 times, where the unstacked forward calls the wrappers 16 +
    4 times; on the CPU both run the plain versions, so the launch counters
    stay put. A vmapped scan that needs a gradient raises."""
    fused_mod = importlib.import_module("vm_asr_tpu_torch.ops.selective_scan_fused")
    lr_mod = importlib.import_module("vm_asr_tpu_torch.ops.linear_recurrence")
    calls = {"fused": 0, "lr": 0, "fused_forward": 0, "lr_forward": 0}

    def spy(module, attr, key, static=None):
        fn = getattr(module, attr)

        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, attr, wrapped)
        if static is not None:
            monkeypatch.setattr(static, "vmap", staticmethod(wrapped))

    spy(fused_mod, "_fused_vmap", "fused", fused_mod._FusedScan)
    spy(lr_mod, "_lr_vmap", "lr", lr_mod._LinearRecurrence)
    spy(fused_mod, "_fused_forward", "fused_forward")
    spy(lr_mod, "_lr_forward", "lr_forward")
    dual, stacked = _pair(dims=16)
    x, hf = _wave(1, 5), np.array([33], np.int32)
    before = (selective_scan_fused.launches, linear_recurrence.launches)
    ref = _run(dual, x, hf)
    assert calls == {"fused": 0, "lr": 0, "fused_forward": 16, "lr_forward": 4}
    got = _run(stacked, x, hf)
    assert calls == {"fused": 8, "lr": 2, "fused_forward": 24, "lr_forward": 6}
    assert (selective_scan_fused.launches, linear_recurrence.launches) == before
    assert float((got - ref).abs().max()) <= STACKED_ABS
    stacked.requires_grad_(True)
    with pytest.raises(RuntimeError, match="serves only"):
        stacked(torch.from_numpy(x), torch.from_numpy(hf).long())
    with pytest.raises(RuntimeError, match="serves only"):
        stacked.train()(torch.from_numpy(x), torch.from_numpy(hf).long())
