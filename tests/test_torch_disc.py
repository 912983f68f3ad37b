"""The port's multi-period discriminator (vm_asr_tpu_torch.models.discriminator)
against the JAX package's, on the CPU: flax variables carried across by
flax_disc_variables_to_state_dict, the same numpy waveforms through both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu.models.discriminator import MultiPeriodDiscriminator as JaxMPD
from vm_asr_tpu_torch.compat import flax_disc_variables_to_state_dict
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.models import MultiPeriodDiscriminator, get_discriminators

# fp32 convolutions and power iteration in other orders (~1e-7 rel observed).
REL = 1e-5
PERIODS = (2, 3, 5)
T = 1001  # no multiple of any period: the reflect pad runs


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def mpd():
    rng = np.random.default_rng(0)
    y = (0.5 * rng.standard_normal((2, 1, T))).astype(np.float32)
    y_hat = (0.5 * rng.standard_normal((2, 1, T))).astype(np.float32)
    jm = JaxMPD(hidden=4, periods=PERIODS)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(y_hat)))
    return jm, variables, y, y_hat


def _port(variables):
    m = MultiPeriodDiscriminator(hidden=4, periods=PERIODS)
    m.load_state_dict(flax_disc_variables_to_state_dict(variables), strict=True)
    return m


@pytest.mark.parametrize("update_stats", [False, True])
def test_scores_and_feature_maps_match_jax(mpd, update_stats):
    """Frozen stats: real and fake as one batch; updating: two calls, each
    advancing the power iteration. Feature maps are NCHW here, NHWC there."""
    jm, variables, y, y_hat = mpd
    out = jm.apply(variables, jnp.asarray(y), jnp.asarray(y_hat), update_stats=update_stats,
                   mutable=["batch_stats"] if update_stats else False)
    ref, new_stats = out if update_stats else (out, None)
    m = _port(variables)
    with torch.no_grad():
        got = m(torch.from_numpy(y), torch.from_numpy(y_hat), update_stats=update_stats)
    for scores_got, scores_ref in zip(got[:2], ref[:2]):
        for g, r in zip(scores_got, scores_ref):
            assert g.shape == r.shape
            assert _rel(g.numpy(), r) < REL
    for fmaps_got, fmaps_ref in zip(got[2:], ref[2:]):
        for per_got, per_ref in zip(fmaps_got, fmaps_ref):
            assert len(per_got) == len(per_ref) == 6
            for g, r in zip(per_got, per_ref):
                assert _rel(g.permute(0, 2, 3, 1).numpy(), r) < REL
    sd = m.state_dict()
    if update_stats:
        after = flax_disc_variables_to_state_dict(
            {"params": variables["params"], "batch_stats": new_stats["batch_stats"]})
        for k in after:
            if k.endswith((".u", ".sigma")):
                assert _rel(sd[k].numpy(), after[k].numpy()) < REL, k
                before = flax_disc_variables_to_state_dict(variables)[k]
                assert not torch.equal(sd[k], before), k  # the statistics moved
    else:  # frozen: one power iteration runs, but nothing is stored
        for k, v in flax_disc_variables_to_state_dict(variables).items():
            assert torch.equal(sd[k], v), k


def test_spectral_norm_gradient_flows_through_sigma(mpd):
    """The weight gradient of a score, against jax.grad with u and v held
    constant as flax holds them."""
    jm, variables, y, _ = mpd

    def jax_score(params):
        s, _, _, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(y), None)
        return sum(jnp.sum(x) for x in s)

    ref = jax.grad(jax_score)(variables["params"])
    m = _port(variables)
    s, _, _, _ = m(torch.from_numpy(y), None)
    sum(x.sum() for x in s).backward()
    ref_sd = flax_disc_variables_to_state_dict({"params": ref})
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_sd[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * np.abs(ref_sd[name].numpy()).max(),
                                   err_msg=name)


def test_param_count_and_factory(mpd):
    jm, variables, _, _ = mpd
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(variables["params"]))
    assert sum(p.numel() for p in _port(variables).parameters()) == n_jax
    c = default_config()
    c.TRAIN.ADVERSARIAL.ENABLE = True
    c.TRAIN.ADVERSARIAL.DISCRIMINATORS = ["mpd"]
    c.AMP_ENABLE = False
    full = get_discriminators(c, "cpu")["mpd"]
    flagship = JaxMPD()  # hidden 32, periods 2/3/5/7/11
    shapes = jax.eval_shape(flagship.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 600)),
                            jnp.zeros((1, 1, 600)))
    assert sum(p.numel() for p in full.parameters()) == \
        sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    c.TRAIN.ADVERSARIAL.DISCRIMINATORS = ["mpd", "msd"]
    with pytest.raises(NotImplementedError):
        get_discriminators(c, "cpu")
