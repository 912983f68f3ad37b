"""The port's generator variants against the JAX package's, on the CPU,
whole model: the single/p2m/m2p streams, MambaUNet, the gated MLP, dropout
(the identity in eval mode) and FUSE_STREAMS in fp32 (one case with the JAX
side through its Pallas kernels in interpret mode), bf16 for the single
stream and MambaUNet, FUSE_STREAMS against the unfused model, and each
variant's weights through the JAX package's state_dict_to_flax. The layouts
and heads are in test_torch_variants_layout.py; the cases and the JAX side
in tests/torch_variants.py."""

import numpy as np
import pytest
import torch

from vm_asr_tpu_torch.models import init_parameters
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_variants import (
    FP32_REL,
    INTERPRET,
    LATENT_DIMS,
    LATENT_STFT,
    STREAM_VARIANTS,
    check_state_dict_to_flax,
    inputs,
    jax_output,
    port_forward,
    port_model,
    rel,
)

# FUSE_STREAMS against the unfused model: a batch of 2B through the decoder's
# matmuls instead of two of B sums in another order (≤ 9e-7 of the output
# scale observed); a fault in the split or the routing moves it by O(1).
FUSE_REL = 1e-5


@pytest.mark.parametrize("name", STREAM_VARIANTS)
def test_variant_fp32_matches_jax(name):
    got = port_forward(name)
    assert got.shape == inputs(name)[0].shape
    assert rel(got, jax_output(name)) < FP32_REL


def test_variant_matches_jax_pallas_interpret():
    """The single-stream case with the JAX side's scans through its Pallas
    kernels (interpret mode) instead of its XLA reference."""
    assert rel(port_forward(INTERPRET), jax_output(INTERPRET, scan_impl="interpret")) < FP32_REL


@pytest.mark.parametrize("name", ["single", "mamba_unet"])
def test_variant_bf16_matches_jax(name):
    """The bar of tests/test_torch_model.py:test_dual_stream_bf16_matches_jax:
    the port's bf16 output is no farther from JAX's bf16 output than twice
    JAX's own bf16 output is from its fp32 output."""
    got = port_forward(name, torch.bfloat16)
    assert np.isfinite(got).all()
    bf16_noise = rel(jax_output(name, "bfloat16"), jax_output(name))
    assert 0 < bf16_noise < 0.2
    assert rel(got, jax_output(name, "bfloat16")) <= 2 * bf16_noise


@pytest.mark.parametrize("name", STREAM_VARIANTS)
def test_variant_state_dict_to_flax(name):
    check_state_dict_to_flax(name)


@pytest.mark.parametrize("opts,applies", [
    (dict(), True), (dict(concat_skip=False), False), (dict(phase_decoder_fix=True), False),
    (dict(dims=LATENT_DIMS, **LATENT_STFT), True)])
def test_fuse_streams_matches_unfused(opts, applies):
    """FUSE_STREAMS batches the two calls of the shared mag decoder into one
    (the JAX package's tests/test_fuse_streams.py): in eval mode the output
    is the unfused model's on the same weights; with additive skips or the
    phase-decoder fix the fusion does not apply and the outputs are equal."""
    fused = port_model("fuse_streams", **opts)
    init_parameters(fused, torch.Generator().manual_seed(0))
    unfused = port_model("fuse_streams", fuse_streams=False, **opts)
    unfused.load_state_dict(fused.state_dict(), strict=True)
    x, hf = (torch.from_numpy(a) for a in inputs(
        "fuse_streams_latent" if "dims" in opts else "fuse_streams"))
    with torch.inference_mode():
        a, b = fused(x, hf), unfused(x, hf)
    if applies:
        assert rel(a, b) < FUSE_REL
    else:
        assert torch.equal(a, b)


def test_fuse_streams_draws_one_mask_stream():
    """In training mode the fused decoder draws one DropPath mask per block
    for the pair's batch: the same seed gives the same output, and the
    draws differ from the unfused model's two."""
    fused = port_model("fuse_streams", drop_path_rate=0.5)
    init_parameters(fused, torch.Generator().manual_seed(0))
    unfused = port_model("fuse_streams", drop_path_rate=0.5, fuse_streams=False)
    unfused.load_state_dict(fused.state_dict(), strict=True)
    x, hf = (torch.from_numpy(a).repeat(4, *([1] * (a.ndim - 1))) for a in inputs("fuse_streams"))
    with torch.no_grad():
        outs = [m.train()(x, hf, generator=torch.Generator().manual_seed(3))
                for m in (fused, fused, unfused)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
