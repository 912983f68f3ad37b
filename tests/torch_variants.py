"""The generator variants of the port's CPU parity tests
(tests/test_torch_variants_*.py), at the small size of
tests/test_torch_model.py, and the JAX side of each, cached for the test
process: its params and its jitted forward in fp32 (and bf16 where asked).

The params are a JAX params tree made from a seeded port init by the JAX
package's own converter (compat.torch_port.state_dict_to_flax), whose tree
test_torch_variants_layout.py holds to the one the JAX model's init makes; a
jitted JAX init of each variant would cost 7-13 s of compile. The v1 head,
which that converter rejects, takes the jitted JAX init."""

import functools

import numpy as np

import jax
import jax.numpy as jnp

import torch

from vm_asr_tpu.compat.torch_port import state_dict_to_flax
from vm_asr_tpu.models import DualStreamInteractiveMambaUNet as JaxDual
from vm_asr_tpu.models import MambaUNet as JaxMambaUNet
from vm_asr_tpu_torch.compat import flax_params_to_state_dict
from vm_asr_tpu_torch.models import DualStreamInteractiveMambaUNet, MambaUNet, init_parameters

# fp32: the same maths in other orders, ~1e-6 of the output scale observed;
# a wiring fault moves the output by O(1) (tests/test_torch_model.py).
FP32_REL = 1e-4
# dims 16 keeps the v3 head's LayerNorms over ≥ 8 channels; n_fft 64, hop
# 16: a 32×32 image (embed 8×8, stages at 8², 4², 2², 1²).
SMALL = dict(dims=16, depths=(1, 1, 1, 1), n_fft=64, hop_length=16, win_length=64)
T = 31 * 16
# The latent layout halves the image once more: n_fft 128, hop 32, a 64×64
# image (embed 16×16, encoders down to 1², the bottleneck at 1²).
LATENT_DIMS = (16, 32, 64, 128, 256)
LATENT_STFT = dict(n_fft=128, hop_length=32, win_length=128)
LATENT_T = 63 * 32

# name → (model class: "dual" | "mamba", constructor options, input rank).
# Input rank 2 with LOW_FREQ_REPLACEMENT in "fixed" mode makes the
# replacement act (on (B, 1, T) input the reference's is a no-op).
VARIANTS = {
    "single": ("dual", dict(interact="single"), 3),
    "single_lfr": ("dual", dict(interact="single", low_freq_replacement=True,
                                lfr_mode="fixed"), 2),
    "p2m": ("dual", dict(interact="p2m"), 3),
    "m2p": ("dual", dict(interact="m2p"), 3),
    "mamba_unet": ("mamba", dict(), 3),
    "mamba_unet_lfr": ("mamba", dict(low_freq_replacement=True, lfr_mode="fixed"), 2),
    "latent": ("dual", dict(dims=LATENT_DIMS), 3),
    "latent_mamba_unet": ("mamba", dict(dims=LATENT_DIMS), 3),
    "latent_additive_skips": ("dual", dict(dims=LATENT_DIMS, concat_skip=False), 3),
    "latent_phase_decoder_fix": ("dual", dict(dims=LATENT_DIMS, phase_decoder_fix=True), 3),
    "head_v2": ("dual", dict(output_version="v2"), 3),
    "head_v1": ("dual", dict(output_version="v1"), 3),
    "head_v1_additive_skips": ("mamba", dict(output_version="v1", concat_skip=False), 3),
    "patch_embed_v1": ("dual", dict(patchembed_version="v1"), 3),
    "gmlp": ("dual", dict(gmlp=True), 3),
    "drop_rates": ("dual", dict(ssm_drop_rate=0.2, mlp_drop_rate=0.3), 3),
    "fuse_streams": ("dual", dict(fuse_streams=True), 3),
    "fuse_streams_latent": ("dual", dict(fuse_streams=True, dims=LATENT_DIMS), 3),
}
# The two test files' shares: the streams and blocks, and the layouts and heads.
LAYOUT_VARIANTS = sorted(n for n in VARIANTS if n.startswith(("latent", "head", "patch"))
                         or n == "fuse_streams_latent")
STREAM_VARIANTS = sorted(set(VARIANTS) - set(LAYOUT_VARIANTS))
# The JAX side of one case runs the Pallas kernels in interpret mode.
INTERPRET = "single"

_JAX = {"dual": JaxDual, "mamba": JaxMambaUNet}
_PORT = {"dual": DualStreamInteractiveMambaUNet, "mamba": MambaUNet}


def wave(rng, batch, t, n_fft):
    """Random waveform with the Nyquist offset and zeroed boundaries of
    vm_asr_tpu/compat/parity_check.py:147-160: without them, angle() of the
    exactly-real Nyquist and boundary bins flips by 2π between the FFTs."""
    x = rng.standard_normal((batch, 1, t))
    x = x + (np.abs(x).max() + 1.0) * (-1.0) ** np.arange(t)
    x[..., :n_fft] = 0.0
    x[..., -n_fft:] = 0.0
    return x.astype(np.float32)


def rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


def options(name):
    kind, kw, _ = VARIANTS[name]
    stft = LATENT_STFT if kw.get("dims") == LATENT_DIMS else {}
    return kind, {**SMALL, **stft, **kw}


def inputs(name):
    n_fft = options(name)[1]["n_fft"]
    x = wave(np.random.default_rng(2), 2, T if n_fft == SMALL["n_fft"] else LATENT_T, n_fft)
    return (x if VARIANTS[name][2] == 3 else x[:, 0]), np.array([10, 11])


def jax_model(name, dtype=jnp.float32, scan_impl="ref"):
    kind, kw = options(name)
    return _JAX[kind](scan_impl=scan_impl, dtype=dtype, **kw)


def jax_init_shapes(name):
    """The params tree the JAX model's init makes, as shapes (traced only)."""
    x, hf = inputs(name)
    return jax.eval_shape(jax_model(name).init, jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(hf))["params"]


@functools.lru_cache(maxsize=None)
def jax_params(name):
    if options(name)[1].get("output_version") == "v1":
        x, hf = inputs(name)
        params = jax.jit(jax_model(name).init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                               jnp.asarray(hf))["params"]
    else:
        m = port_model(name)
        init_parameters(m, torch.Generator().manual_seed(0))
        params = state_dict_to_flax({k: v.numpy() for k, v in m.state_dict().items()},
                                    drop_phase_decoders=False)
    return jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def jax_output(name, dtype="float32", scan_impl="ref"):
    x, hf = inputs(name)
    model = jax_model(name, getattr(jnp, dtype), scan_impl)
    return np.asarray(jax.jit(model.apply)({"params": jax_params(name)}, jnp.asarray(x),
                                           jnp.asarray(hf)))


def port_model(name, **overrides):
    kind, kw = options(name)
    return _PORT[kind](**{**kw, **overrides}).eval()


def port_forward(name, compute_dtype=torch.float32):
    """The port's output on ``inputs(name)`` with ``jax_params(name)`` loaded
    by flax_params_to_state_dict and load_state_dict(strict=True)."""
    m = port_model(name, compute_dtype=compute_dtype)
    m.load_state_dict(flax_params_to_state_dict(jax_params(name)), strict=True)
    x, hf = inputs(name)
    with torch.inference_mode():
        return m(torch.from_numpy(x), torch.from_numpy(hf)).numpy()


def check_state_dict_to_flax(name):
    """The port's state_dict through the JAX package's state_dict_to_flax
    gives the tree the JAX model's init makes, leaf for leaf."""
    sd = port_model(name).state_dict()
    back = state_dict_to_flax({k: v.numpy() for k, v in sd.items()}, drop_phase_decoders=False)
    want = jax_init_shapes(name)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(back)):
        assert a.shape == np.shape(b), path
