"""The port's VMamba classifier and backbone (vm_asr_tpu_torch/models/vssm.py)
against the JAX package's, on the CPU: the same weights (a seeded port init
carried into the JAX tree), the same numpy image through both. N = 1 and
N = 4, which takes the general-N route (one recurrence per state channel)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu.models import BackboneVSSM as JaxBackboneVSSM
from vm_asr_tpu.models import VSSM as JaxVSSM
from vm_asr_tpu_torch.compat import flax_params_to_state_dict
from vm_asr_tpu_torch.models import VSSM, BackboneVSSM, get_vssm

from torch_threads import one_torch_thread  # noqa: F401
from torch_vssm import FP32_REL, jax_params_from_port, port_init, rel

SMALL = dict(dims=8, depths=(1, 1, 1, 1))
# Gradients: the same fp32 maths summed in other orders; 1e-3 of each
# tensor's scale (the port's CPU whole-step bar, tests/test_torch_train_step.py).
GRAD_REL = 1e-3


def _image(seed, batch=2):
    return np.random.default_rng(seed).standard_normal((batch, 32, 32, 3)).astype(np.float32)


def test_classifier_matches_jax():
    x = _image(1)
    port = port_init(VSSM(num_classes=10, ssm_d_state=1, **SMALL), seed=1)
    jm = JaxVSSM(num_classes=10, ssm_d_state=1, scan_impl="ref", **SMALL)
    params = jax_params_from_port(jm, (jnp.asarray(x),), port)
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    assert rel(got, ref) < FP32_REL


def test_classifier_and_gradients_match_jax():
    """N = 4: the logits, and the gradients of <logits, a seeded cotangent>
    with respect to every parameter (the recurrence's reverse as the
    backward), against one jitted JAX vjp."""
    x = _image(7)
    ct = np.random.default_rng(8).standard_normal((2, 10)).astype(np.float32)
    port = port_init(VSSM(num_classes=10, ssm_d_state=4, drop_path_rate=0.0, **SMALL), seed=9)
    jm = JaxVSSM(num_classes=10, ssm_d_state=4, drop_path_rate=0.0, scan_impl="ref", **SMALL)
    params = jax_params_from_port(jm, (jnp.asarray(x),), port)

    @jax.jit
    def logits_and_grads(p):
        logits, vjp = jax.vjp(lambda q: jm.apply({"params": q}, jnp.asarray(x)), p)
        return logits, vjp(jnp.asarray(ct))[0]

    ref_logits, jgrad = logits_and_grads(params)
    ref = {k: v.numpy() for k, v in flax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jgrad)).items()}
    named = list(port.named_parameters())
    logits = port(torch.from_numpy(x))
    grads = dict(zip((n for n, _ in named), torch.autograd.grad(
        (logits * torch.from_numpy(ct)).sum(), [p for _, p in named])))
    assert rel(logits.detach().numpy(), ref_logits) < FP32_REL
    assert set(ref) == set(grads)
    # The last stage is 1×1 (L = 1): its states have no past, so its A_logs
    # take no gradient on either side. Every other tensor has one.
    flat = "stages.3.blocks.0.op.A_logs"
    assert not np.abs(ref[flat]).max() and not grads[flat].abs().max()
    assert all(grads[k].abs().max() > 0 for k in grads if k != flat)
    assert max(rel(grads[k].numpy(), ref[k]) for k in ref if k != flat) < GRAD_REL


@pytest.mark.parametrize("d_state", [1, 4])
def test_backbone_matches_jax(d_state):
    x = _image(10 + d_state, batch=1)
    kw = dict(ssm_d_state=d_state, out_indices=(0, 2, 3), **SMALL)
    port = port_init(BackboneVSSM(**kw), seed=5)
    jm = JaxBackboneVSSM(scan_impl="ref", **kw)
    params = jax_params_from_port(jm, (jnp.asarray(x),), port)
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    # Stage i ends in its PatchMerging: 32/4/2^(i+1) wide, dims 8·2^(i+1).
    assert [tuple(f.shape) for f in got] == [(1, 4, 4, 16), (1, 1, 1, 64), (1, 1, 1, 64)]
    for g, r in zip(got, ref):
        assert rel(g.numpy(), r) < FP32_REL


def test_get_vssm_is_seeded_and_defaults_to_the_card():
    kw = dict(num_classes=10, **SMALL)
    a = get_vssm("cpu", seed=3, **kw).state_dict()
    b = get_vssm("cpu", seed=3, **kw).state_dict()
    c = get_vssm("cpu", seed=4, **kw).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    backbone = get_vssm("cpu", seed=3, cls=BackboneVSSM, **SMALL)
    assert type(backbone) is BackboneVSSM and not backbone.training
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_vssm(**kw)


def test_drop_path_draws_from_the_callers_generator():
    """In training the DropPath rates rise from 0 over the blocks and the
    masks come from the caller's generator: one seed, one output."""
    x = torch.from_numpy(_image(12, batch=4))
    m = get_vssm("cpu", seed=1, num_classes=10, drop_path_rate=0.5, **SMALL).train()
    rates = [b.drop_path.rate for s in m.stages for b in s.blocks]
    assert rates == pytest.approx(list(np.linspace(0.0, 0.5, 4)))
    with torch.no_grad():
        one = m(x, torch.Generator().manual_seed(0))
        two = m(x, torch.Generator().manual_seed(0))
        other = m(x, torch.Generator().manual_seed(1))
    assert torch.equal(one, two)
    assert not torch.equal(one, other)
    with pytest.raises(ValueError, match="explicit"):
        m(x)
