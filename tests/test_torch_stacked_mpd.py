"""The port's period-stacked MPD (StackedMultiPeriodDiscriminator,
stack_mpd_state, unstack_mpd_state) on the CPU: against the port's unstacked
MPD on the same parameters, at the bars of the JAX package's own test
(tests/test_stacked_mpd.py:56-133), and against the JAX stacked MPD on its
variables carried across."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu.models.discriminator import MultiPeriodDiscriminator as JaxMPD
from vm_asr_tpu.models.discriminator import StackedMultiPeriodDiscriminator as JaxStackedMPD
from vm_asr_tpu.models.discriminator import stack_mpd_params
from vm_asr_tpu_torch import losses as L
from vm_asr_tpu_torch.compat import flax_disc_variables_to_state_dict
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.models import (
    MultiPeriodDiscriminator,
    StackedMultiPeriodDiscriminator,
    get_discriminators,
    init_parameters,
    stack_mpd_state,
    unstack_mpd_state,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

PERIODS = (2, 3, 5)
T = 97  # no multiple of any period: the reflect fold pad runs
HIDDEN = 4
GROUPS = [None, ((2, 3), (5,))]
# The JAX package's bars (tests/test_stacked_mpd.py): the valid region of a
# grouped conv is the dense conv's up to the order of its sums.
ATOL, RTOL = 2e-6, 1e-5
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 3e-6, 2e-5


def _pair(seed=0, b=2):
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.standard_normal((b, 1, T)).astype(np.float32))
                 for _ in range(2))


def _models(groups=None):
    """A seeded unstacked MPD and a stacked one with the same state."""
    un = MultiPeriodDiscriminator(hidden=HIDDEN, periods=PERIODS)
    init_parameters(un, torch.Generator().manual_seed(0))
    st = StackedMultiPeriodDiscriminator(hidden=HIDDEN, periods=PERIODS, groups=groups)
    st.load_state_dict(un.state_dict(), strict=True)
    return un, st


def _close(a, b, atol=ATOL, rtol=RTOL):
    torch.testing.assert_close(a, b, atol=atol, rtol=rtol)


@pytest.mark.parametrize("groups", GROUPS)
def test_scores_and_feature_maps_match(groups):
    un, st = _models(groups)
    y, yh = _pair()
    with torch.no_grad():
        ref, got = un(y, yh), st(y, yh)
    for i in range(len(PERIODS)):
        _close(got[0][i], ref[0][i])
        _close(got[1][i], ref[1][i])
        for fr, fg in ((ref[2][i], got[2][i]), (ref[3][i], got[3][i])):
            assert len(fr) == len(fg) == 6
            for a, b in zip(fg, fr):
                assert a.shape == b.shape
                _close(a, b)
    with torch.no_grad():  # real only: no fake scores, as the unstacked MPD
        alone = st(y, None)
    assert alone[1] == [0] * len(PERIODS) and alone[3] == [0] * len(PERIODS)
    _close(alone[0][2], ref[0][2])


def test_losses_match():
    un, st = _models()
    y, yh = _pair()
    with torch.no_grad():
        a, b = un(y, yh), st(y, yh)
    for fn in (lambda o: L.discriminator_loss(o[0], o[1], "lsgan"),
               lambda o: L.generator_adversarial_loss(o[1], "lsgan"),
               lambda o: L.feature_matching_loss(o[2], o[3])):
        _close(fn(b), fn(a), atol=0, rtol=LOSS_RTOL)


@pytest.mark.parametrize("groups", GROUPS)
def test_update_stats_power_iteration_matches(groups):
    """The discriminator pass (update_stats) runs real then fake; each
    spectral-norm power iteration advances as the unstacked MPD's."""
    un, st = _models(groups)
    y, yh = _pair()
    with torch.no_grad():
        un(y, yh, update_stats=True)
        st(y, yh, update_stats=True)
    ref, got = un.state_dict(), st.state_dict()
    stats = [k for k in ref if k.endswith((".u", ".sigma"))]
    assert len(stats) == 2 * 6 * len(PERIODS)
    for k in stats:
        _close(got[k], ref[k])
    init = MultiPeriodDiscriminator(hidden=HIDDEN, periods=PERIODS)
    init_parameters(init, torch.Generator().manual_seed(0))
    assert not torch.equal(got[stats[0]], init.state_dict()[stats[0]])  # they moved


def test_grads_match():
    un, st = _models(((2, 3), (5,)))
    y, yh = _pair()
    grads = []
    for m in (un, st):
        s_r, s_g, _, _ = m(y, yh)
        grads.append(torch.autograd.grad(L.discriminator_loss(s_r, s_g, "lsgan"),
                                         list(m.parameters())))
    names = [n for n, _ in un.named_parameters()]
    assert names == [n for n, _ in st.named_parameters()]  # one optimizer layout
    for a, b in zip(*grads):
        _close(b, a, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_state_roundtrip():
    """stack_mpd_state / unstack_mpd_state, the JAX package's
    stack_mpd_params / unstack_mpd_params on the port's names; the stacked
    module keeps the unstacked layout, so a run switches MPD_STACKED between
    resumes."""
    un, st = _models(((2, 3), (5,)))
    sd = un.state_dict()
    stacked = stack_mpd_state(sd, PERIODS, ((2, 3), (5,)))
    assert stacked["group_0.convs.0.weight"].shape == (2, *sd["discriminators.0.convs.0.weight"].shape)
    assert stacked["group_1.conv_post.u"].shape == (1, 1, 1)
    back = unstack_mpd_state(stacked, PERIODS, ((2, 3), (5,)))
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    assert sorted(st.state_dict()) == sorted(sd)
    with pytest.raises(ValueError, match="partition"):
        StackedMultiPeriodDiscriminator(hidden=HIDDEN, periods=PERIODS, groups=((3, 2), (5,)))


def test_factory_knob():
    c = default_config()
    c.TRAIN.ADVERSARIAL.ENABLE = True
    c.TRAIN.ADVERSARIAL.DISCRIMINATORS = ["mpd"]
    c.TRAIN.ADVERSARIAL.MPD_HIDDEN = HIDDEN
    c.TRAIN.ADVERSARIAL.MPD_PERIODS = [2, 3]
    c.TRAIN.ADVERSARIAL.MPD_STACKED = True
    c.TRAIN.ADVERSARIAL.MPD_STACK_GROUPS = [[2], [3]]
    c.AMP_ENABLE = False
    mpd = get_discriminators(c, "cpu")["mpd"]
    assert isinstance(mpd, StackedMultiPeriodDiscriminator) and mpd.groups == ((2,), (3,))
    c.TRAIN.ADVERSARIAL.MPD_STACKED = False
    plain = get_discriminators(c, "cpu")["mpd"]
    # The same seeded initialisation with the option on or off.
    assert all(torch.equal(a, b) for a, b in zip(mpd.state_dict().values(),
                                                  plain.state_dict().values()))


def test_matches_jax_stacked_mpd():
    """JAX variables stacked by stack_mpd_params (group_g subtrees) convert
    to the port's unstacked layout (flax_disc_variables_to_state_dict with
    the periods and groups) exactly as the unstacked variables do, and the
    port's stacked MPD on them gives the JAX stacked MPD's scores and
    feature maps."""
    groups = ((2, 3), (5,))
    y, yh = _pair(1)
    jy, jyh = jnp.asarray(y.numpy()), jnp.asarray(yh.numpy())
    v_un = jax.tree_util.tree_map(np.asarray, JaxMPD(hidden=HIDDEN, periods=PERIODS).init(
        jax.random.PRNGKey(0), jy, jyh))
    v_st = stack_mpd_params(v_un, periods=PERIODS, groups=groups)
    direct = flax_disc_variables_to_state_dict(v_un)
    via = flax_disc_variables_to_state_dict(v_st, PERIODS, groups)
    assert sorted(via) == sorted(direct) and all(torch.equal(via[k], direct[k]) for k in direct)
    ref = JaxStackedMPD(hidden=HIDDEN, periods=PERIODS, groups=groups).apply(v_st, jy, jyh)
    st = StackedMultiPeriodDiscriminator(hidden=HIDDEN, periods=PERIODS, groups=groups)
    st.load_state_dict(via, strict=True)
    with torch.no_grad():
        got = st(y, yh)
    for i in range(len(PERIODS)):
        _close(got[0][i], torch.from_numpy(np.array(ref[0][i])))
        for a, b in zip(got[3][i], ref[3][i]):  # NCHW here, NHWC there
            _close(a.permute(0, 2, 3, 1), torch.from_numpy(np.array(b)))
