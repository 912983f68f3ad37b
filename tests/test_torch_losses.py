"""The port's losses (vm_asr_tpu_torch.losses) against vm_asr_tpu.losses, on
the CPU: the same numpy inputs through both, fp32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu import losses as JL
from vm_asr_tpu_torch import losses as L

# fp32 maths in other orders (FFT, reductions): ~1e-7 rel observed.
REL = 1e-5


def _close(got, ref):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    ref = float(ref)
    assert abs(got - ref) <= REL * abs(ref), (got, ref)


def _waves(seed, b=2, t=3000):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((b, t))).astype(np.float32)
    y = (0.3 * rng.standard_normal((b, t))).astype(np.float32)
    return x, y


def test_waveform_losses():
    x, y = _waves(0)
    _close(L.mae_loss(torch.from_numpy(x), torch.from_numpy(y)), JL.mae_loss(x, y))
    _close(L.mse_loss(torch.from_numpy(x), torch.from_numpy(y)), JL.mse_loss(x, y))


@pytest.mark.parametrize("emphasize", [False, True])
def test_stft_loss(emphasize):
    """One resolution: a window shorter than n_fft (centre-padded), reflect
    padding, the 1e-7 power floor."""
    x, y = _waves(1)
    got = L.stft_loss(torch.from_numpy(x), torch.from_numpy(y), 512, 50, 240, emphasize)
    ref = JL.stft_loss(jnp.asarray(x), jnp.asarray(y), 512, 50, 240, emphasize)
    for g, r in zip(got, ref):
        _close(g, r)


def test_multi_resolution_stft_loss():
    x, y = _waves(2)
    got = L.multi_resolution_stft_loss(torch.from_numpy(x), torch.from_numpy(y),
                                       factor_sc=0.3, factor_mag=0.7)
    ref = JL.multi_resolution_stft_loss(jnp.asarray(x), jnp.asarray(y),
                                        factor_sc=0.3, factor_mag=0.7)
    for g, r in zip(got, ref):
        _close(g, r)


def _scores(seed):
    rng = np.random.default_rng(seed)
    shapes = [(2, 7), (2, 11)]
    real = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    fake = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return real, fake


@pytest.mark.parametrize("gan_type", ["lsgan", "wgan"])
def test_adversarial_losses(gan_type):
    real, fake = _scores(3)
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    _close(L.discriminator_loss(t(real), t(fake), gan_type),
           JL.discriminator_loss(real, fake, gan_type))
    _close(L.generator_adversarial_loss(t(fake), gan_type),
           JL.generator_adversarial_loss(fake, gan_type))


def test_bf16_scores_reduce_in_fp32():
    real, fake = _scores(4)
    got = L.discriminator_loss([torch.from_numpy(x).to(torch.bfloat16) for x in real],
                               [torch.from_numpy(x).to(torch.bfloat16) for x in fake])
    assert got.dtype == torch.float32
    ref = JL.discriminator_loss([jnp.asarray(x, jnp.bfloat16) for x in real],
                                [jnp.asarray(x, jnp.bfloat16) for x in fake])
    _close(got, ref)


def test_feature_matching_loss():
    rng = np.random.default_rng(5)
    shapes = [[(2, 3, 4), (2, 5)], [(2, 6), (2, 2, 2), (2, 1)]]
    fr = [[rng.standard_normal(s).astype(np.float32) for s in d] for d in shapes]
    fg = [[rng.standard_normal(s).astype(np.float32) for s in d] for d in shapes]
    tt = lambda f: [[torch.from_numpy(x) for x in d] for d in f]  # noqa: E731
    _close(L.feature_matching_loss(tt(fr), tt(fg)), JL.feature_matching_loss(fr, fg))


def test_gradient_penalty_with_the_same_alpha():
    """The penalty and its gradient in the critic's weight, with JAX's alpha
    (drawn from its rng) handed to the port. The critic is a small nonlinear
    map, so the penalty depends on the weight through the input gradient."""
    rng = np.random.default_rng(6)
    real = rng.standard_normal((3, 1, 40)).astype(np.float32)
    fake = rng.standard_normal((3, 1, 40)).astype(np.float32)
    w = rng.standard_normal((40,)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    alpha = np.array(jax.random.uniform(key, (3, 1, 1)))

    def jax_pen(w_):
        apply = lambda x: [jnp.tanh(x[:, 0] * w_), jnp.sin(x[:, 0] @ w_)]  # noqa: E731
        return JL.gradient_penalty(apply, jnp.asarray(real), jnp.asarray(fake), key,
                                   gp_weight=10.0)

    ref, ref_grad = jax.value_and_grad(jax_pen)(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()
    apply = lambda x: [torch.tanh(x[:, 0] * tw), torch.sin(x[:, 0] @ tw)]  # noqa: E731
    got = L.gradient_penalty(apply, torch.from_numpy(real), torch.from_numpy(fake),
                             torch.from_numpy(alpha), gp_weight=10.0)
    _close(got, ref)
    (got_grad,) = torch.autograd.grad(got, tw)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(ref_grad), rtol=REL,
                               atol=REL * np.abs(np.asarray(ref_grad)).max())
