"""The port's remaining adversarial options against the JAX package on the
CPU: the multi-scale discriminator (MultiScaleDiscriminator) on flax
variables carried across, and GAN train steps with the MSD beside the
period-stacked MPD and with the period-stacked MPD under GAN_LOSS_TYPE
wgan-gp, each held to the JAX package's make_train_step from the same state
and batch, the penalty's interpolation weights drawn as the JAX step draws
them (fold_in(rng, di)) and injected."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu.compat.torch_port import state_dict_to_flax
from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.models import get_model
from vm_asr_tpu.models.discriminator import MultiScaleDiscriminator as JaxMSD
from vm_asr_tpu.models.discriminator import stack_mpd_params
from vm_asr_tpu.train.optim import make_optimizer as jax_make_optimizer
from vm_asr_tpu.train.states import DiscState as JaxDiscState
from vm_asr_tpu.train.states import GenState as JaxGenState
from vm_asr_tpu.train.steps import make_train_step as jax_make_train_step
from vm_asr_tpu_torch.compat import flax_disc_variables_to_state_dict, flax_params_to_state_dict
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.models import (
    MultiScaleDiscriminator,
    StackedMultiPeriodDiscriminator,
    get_discriminators,
    get_generator,
)
from vm_asr_tpu_torch.train import DiscState, GenState, make_optimizer, make_train_step
from vm_asr_tpu_torch.train.steps import gp_alphas
from tests.torch_threads import one_torch_thread  # noqa: F401

# The same fp32 maths in other orders: convolutions, the power iteration,
# the penalty's double backward (~1e-7 rel observed for the MPD).
REL = 1e-5
# The whole step, the PR 2 bars of tests/test_torch_train_step.py: metrics
# 1e-4 relative (the MPD-only step matched within 4.3e-7); spectral-norm
# statistics after the step 1e-5 of their scale; parameters after the step
# as _updates_close says.
METRIC_REL = 1e-4
STATS_REL = 1e-5
STEPS_PER_EPOCH = 10
LR = 1e-3
T, B = 2016, 2
GROUPS = ((2,), (3, 5))
MSD_HIDDEN = 16  # the smallest width whose grouped convs (16 groups) divide


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def msd():
    rng = np.random.default_rng(0)
    y = (0.5 * rng.standard_normal((2, 1, 1001))).astype(np.float32)
    y_hat = (0.5 * rng.standard_normal((2, 1, 1001))).astype(np.float32)
    jm = JaxMSD(hidden=MSD_HIDDEN)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(y_hat)))
    return jm, variables, y, y_hat


@pytest.mark.parametrize("update_stats", [False, True])
def test_msd_matches_jax(msd, update_stats):
    """Scores, feature maps (NCW here, NWC there) and, with update_stats, the
    power-iteration statistics of every conv of the three scales."""
    jm, variables, y, y_hat = msd
    out = jm.apply(variables, jnp.asarray(y), jnp.asarray(y_hat), update_stats=update_stats,
                   mutable=["batch_stats"] if update_stats else False)
    ref, new_stats = out if update_stats else (out, None)
    m = MultiScaleDiscriminator(hidden=MSD_HIDDEN)
    m.load_state_dict(flax_disc_variables_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(y), torch.from_numpy(y_hat), update_stats=update_stats)
    for scores_got, scores_ref in zip(got[:2], ref[:2]):
        assert len(scores_got) == 3
        for g, r in zip(scores_got, scores_ref):
            assert g.shape == r.shape and _rel(g.numpy(), r) < REL
    for fmaps_got, fmaps_ref in zip(got[2:], ref[2:]):
        for per_got, per_ref in zip(fmaps_got, fmaps_ref):
            assert len(per_got) == len(per_ref) == 8
            for g, r in zip(per_got, per_ref):
                assert _rel(g.permute(0, 2, 1).numpy(), r) < REL
    if update_stats:
        after = flax_disc_variables_to_state_dict(
            {"params": variables["params"], "batch_stats": new_stats["batch_stats"]})
        sd = m.state_dict()
        for k in (k for k in after if k.endswith((".u", ".sigma"))):
            assert _rel(sd[k].numpy(), after[k].numpy()) < REL, k


def test_msd_parameters_and_factory():
    """The flagship MSD (hidden 128) has the JAX MSD's parameter count; the
    factory builds it beside the MPD, the MPD's seeded init unchanged by it."""
    c = default_config()
    c.TRAIN.ADVERSARIAL.ENABLE = True
    c.TRAIN.ADVERSARIAL.DISCRIMINATORS = ["mpd", "msd"]
    c.TRAIN.ADVERSARIAL.MPD_HIDDEN = 2
    c.AMP_ENABLE = False
    discs = get_discriminators(c, "cpu")
    assert sorted(discs) == ["mpd", "msd"] and isinstance(discs["msd"], MultiScaleDiscriminator)
    shapes = jax.eval_shape(JaxMSD().init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 600)),
                            jnp.zeros((1, 1, 600)))
    assert sum(p.numel() for p in discs["msd"].parameters()) == \
        sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    c.TRAIN.ADVERSARIAL.DISCRIMINATORS = ["mpd"]
    alone = get_discriminators(c, "cpu")["mpd"]
    assert all(torch.equal(a, b) for a, b in zip(alone.state_dict().values(),
                                                  discs["mpd"].state_dict().values()))


def test_gp_alphas_are_reproducible():
    """One draw of the step's generator seeds each discriminator's weights by
    its index: the same seed gives the same weights, the indices differ."""
    a = gp_alphas(torch.Generator().manual_seed(3), 4, 2)
    b = gp_alphas(torch.Generator().manual_seed(3), 4, 2)
    assert [x.shape for x in a] == [(4, 1, 1)] * 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1]) and bool(((a[0] >= 0) & (a[0] < 1)).all())


# The two steps held to the JAX step, each one jitted JAX program: the MSD
# beside the period-stacked MPD (LSGAN), and the period-stacked MPD under
# wgan-gp. (The MSD's grouped convs are dense-conv loops in the JAX package,
# and its penalty's double backward alone took ~60 s of XLA compile on the
# CPU.) The generator is the single-stream MambaUNet, its weights a seeded
# port init carried to flax, which spares the JAX model's jitted init.
STEPS = {
    "msd_and_stacked_mpd": dict(DISCRIMINATORS=["mpd", "msd"], GAN_LOSS_TYPE="lsgan"),
    "wgan_gp_stacked_mpd": dict(DISCRIMINATORS=["mpd"], GAN_LOSS_TYPE="wgan-gp"),
}


def _tiny(c, case):
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = 0.126  # 2016 samples → 64-frame spectral image
    c.DATA.STFT.N_FFT = 128
    c.DATA.STFT.HOP_LENGTH = 32
    c.DATA.STFT.WIN_LENGTH = 128
    c.MODEL.NAME = "MambaUNet"
    c.MODEL.VSSM.DIMS = 8
    c.MODEL.VSSM.DEPTHS = [1, 1, 1, 1]
    c.MODEL.VSSM.DROP_PATH_RATE = 0.0
    c.TRAIN.EPOCHS = 1
    c.TRAIN.WARMUP_EPOCHS = 0
    c.TRAIN.LOSSES.GEN = ["l1"]
    c.TRAIN.ADVERSARIAL.ENABLE = True
    c.TRAIN.ADVERSARIAL.MPD_HIDDEN = 2
    c.TRAIN.ADVERSARIAL.MPD_PERIODS = [2, 3, 5]
    c.TRAIN.ADVERSARIAL.MPD_STACKED = True
    c.TRAIN.ADVERSARIAL.MPD_STACK_GROUPS = [list(g) for g in GROUPS]
    c.TRAIN.ADVERSARIAL.MSD_HIDDEN = MSD_HIDDEN
    c.TRAIN.ADVERSARIAL.DISC_INPUT_GAIN = 2.0  # the penalty in D's own input space
    for key, value in STEPS[case].items():
        c.TRAIN.ADVERSARIAL[key] = value
    c.DTYPE.COMPUTE = "float32"
    c.AMP_ENABLE = False
    return c


def _batch():
    """The Nyquist-offset input of tests/test_torch_train_step.py (angle()
    of the exactly-real bins agrees between the two FFTs)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 1, T))
    x = x + (np.abs(x).max() + 1.0) * (-1.0) ** np.arange(T)
    x[..., :128] = 0.0
    x[..., -128:] = 0.0
    y = 0.3 * rng.standard_normal((B, 1, T))
    return (0.1 * x).astype(np.float32), y.astype(np.float32), np.array([16, 40], np.int32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(STEPS))
def steps(request):
    """One JAX step and one port step from the same generator and
    discriminator state (the JAX stacked MPD's variables stacked from the
    unstacked ones, the port's loaded unstacked), the same batch and, under
    wgan-gp, the same interpolation weights."""
    case = request.param
    pcfg = _tiny(default_config(), case)
    model = get_generator(pcfg, "cpu")
    gen_params = state_dict_to_flax({k: v.numpy() for k, v in model.state_dict().items()})
    cfg = _tiny(jax_default_config(), case)
    models = get_model(cfg)
    x, y, hf = _batch()
    periods = tuple(cfg.TRAIN.ADVERSARIAL.MPD_PERIODS)
    un_cfg = _tiny(jax_default_config(), case)
    un_cfg.TRAIN.ADVERSARIAL.MPD_STACKED = False
    disc_vars = {n: _np(jax.jit(get_model(un_cfg)[n].init)(
        jax.random.PRNGKey(1 + i), jnp.asarray(y), jnp.asarray(y)))
        for i, n in enumerate(sorted(cfg.TRAIN.ADVERSARIAL.DISCRIMINATORS))}
    jax_disc = {n: stack_mpd_params(v, periods=periods, groups=GROUPS) if n == "mpd" else v
                for n, v in disc_vars.items()}
    opt = lambda: jax_make_optimizer(cfg, STEPS_PER_EPOCH)  # noqa: E731
    gs = JaxGenState.create(jax.tree_util.tree_map(jnp.asarray, gen_params), opt())
    ds = {n: JaxDiscState.create(jax.tree_util.tree_map(jnp.asarray, v), opt())
          for n, v in jax_disc.items()}
    step = jax_make_train_step(cfg, models["generator"], {n: models[n] for n in jax_disc})
    batch = {"wave_input": jnp.asarray(x), "wave_target": jnp.asarray(y),
             "highcut": jnp.asarray(hf)}
    rng = jax.random.PRNGKey(5)
    gs2, ds2, metrics = jax.jit(step)(gs, ds, batch, rng)
    alphas = [np.array(jax.random.uniform(jax.random.fold_in(rng, di), (B, 1, 1)))
              for di in range(len(jax_disc))]
    ref = dict(metrics={k: float(v) for k, v in metrics.items()},
               gen=flax_params_to_state_dict(_np(gs2.params)),
               discs={n: flax_disc_variables_to_state_dict(
                   {"params": _np(ds2[n].params), "batch_stats": _np(ds2[n].batch_stats)},
                   periods, GROUPS) for n in jax_disc})

    discs = get_discriminators(pcfg, "cpu")
    for n, v in disc_vars.items():
        discs[n].load_state_dict(flax_disc_variables_to_state_dict(v), strict=True)
    drawn = []

    def inject(rng_, batch_, count):
        drawn.append((batch_, count))
        return [torch.from_numpy(a) for a in alphas]

    pstep = make_train_step(pcfg, model, discs, gp_alpha=inject)
    gen_state = GenState(model, make_optimizer(pcfg, STEPS_PER_EPOCH, model))
    disc_states = {n: DiscState(d, make_optimizer(pcfg, STEPS_PER_EPOCH, d))
                   for n, d in discs.items()}
    tb = {"wave_input": torch.from_numpy(x), "wave_target": torch.from_numpy(y),
          "highcut": torch.from_numpy(hf).long()}
    _, _, got = pstep(gen_state, disc_states, tb, torch.Generator().manual_seed(0))
    return case, ref, dict(metrics={k: float(v) for k, v in got.items()}, model=model,
                           discs=discs, drawn=drawn)


def test_step_metrics_match_jax(steps):
    case, ref, got = steps
    assert isinstance(got["discs"]["mpd"], StackedMultiPeriodDiscriminator)
    names = sorted(got["discs"])
    want = {f"generator/{t}_{n}" for t in ("adversarial", "features") for n in names} | \
        {f"discriminator/{n}" for n in names} | {f"disc_gap/{n}_max" for n in names}
    assert want | {"total_disc_loss"} <= set(got["metrics"])
    assert set(got["metrics"]) == set(ref["metrics"])
    # wgan-gp: one draw a step, one set of weights per discriminator.
    assert got["drawn"] == ([(B, 1)] if case.startswith("wgan") else [])
    for k, r in ref["metrics"].items():
        assert abs(got["metrics"][k] - r) <= METRIC_REL * abs(r), (k, got["metrics"][k], r)


def _updates_close(got, ref, keys):
    """AdamW's first update is lr·g/(|g| + eps) ≈ ±lr per element, so an
    element whose gradient is fp32 noise (or within a few eps, as some of
    the penalty's double-backward terms are) may step apart by up to 2·lr;
    only a few elements may differ at all (tests/test_torch_train_step.py's
    rule for the generator)."""
    diff = np.concatenate([(got[k] - ref[k]).abs().numpy().ravel() for k in keys]) / LR
    assert diff.max() <= 2.0 + 1e-3 and (diff > 0.01).mean() <= 1e-3, \
        (diff.max(), (diff > 0.01).mean())


def test_step_updates_match_jax(steps):
    """The generator and each discriminator after the step (their gradients
    carry the penalty's double backward under wgan-gp), and each
    discriminator's power-iteration statistics."""
    _, ref, got = steps
    gen = got["model"].state_dict()
    assert sorted(gen) == sorted(ref["gen"])
    _updates_close(gen, ref["gen"], ref["gen"])
    for name, want in ref["discs"].items():
        sd = got["discs"][name].state_dict()
        assert sorted(sd) == sorted(want)
        stats = [k for k in want if k.endswith((".u", ".sigma"))]
        for k in stats:
            err = float((sd[k] - want[k]).abs().max())
            assert err <= STATS_REL * float(want[k].abs().max()), (name, k, err)
        _updates_close(sd, want, [k for k in want if k not in stats])
