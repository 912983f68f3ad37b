"""The port's generator variants against the JAX package's, on the CPU,
whole model: the latent (5-dims) layout (dual-stream, MambaUNet, additive
skips, the phase-decoder fix, FUSE_STREAMS), the v1 and v2 heads and
patch-embed v1, in fp32; and each variant's weights through the JAX
package's state_dict_to_flax (not the v1 head's, which it rejects). The
cases and the JAX side are in tests/torch_variants.py."""

import pytest

from vm_asr_tpu.compat.torch_port import state_dict_to_flax
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_variants import (
    FP32_REL,
    LAYOUT_VARIANTS,
    check_state_dict_to_flax,
    inputs,
    jax_output,
    port_forward,
    port_model,
    rel,
)


@pytest.mark.parametrize("name", LAYOUT_VARIANTS)
def test_variant_fp32_matches_jax(name):
    got = port_forward(name)
    assert got.shape == inputs(name)[0].shape
    assert rel(got, jax_output(name)) < FP32_REL


@pytest.mark.parametrize("name", [n for n in LAYOUT_VARIANTS if not n.startswith("head_v1")])
def test_variant_state_dict_to_flax(name):
    check_state_dict_to_flax(name)


def test_latent_layout_names():
    """The bottleneck sits at the reference's layers_latent.0, and every
    decoder stage of the latent layout takes a skip and upsamples."""
    sd = port_model("latent").state_dict()
    assert "layers_latent_mag.0.blocks.0.op.A_logs" in sd
    assert "layers_latent_phase.0.blocks.0.op.A_logs" in sd
    assert all(f"layers_decoder_mag.{i}.skip_handler.1.weight" in sd for i in range(4))
    assert all(f"layers_decoder_mag.{i}.sampler.expand.weight" in sd for i in range(4))
    assert not any(k.startswith("layers_decoder_phase") for k in sd)


def test_head_v1_names_and_rejection():
    """The v1 head carries the JAX package's module names; the JAX package's
    state_dict_to_flax rejects it."""
    sd = port_model("head_v1").state_dict()
    assert {"output_layer_mag.out_skip_conv.weight", "output_layer_mag.out_convt1.weight",
            "output_layer_mag.out_convt2.bias"} <= set(sd)
    assert sd["output_layer_mag.out_convt1.weight"].shape == (16, 8, 3, 3)
    with pytest.raises(NotImplementedError, match="v1"):
        state_dict_to_flax({k: v.numpy() for k, v in sd.items()})
