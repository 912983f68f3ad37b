"""The port's GAN train step against the JAX package's
(vm_asr_tpu.train.steps.make_train_step), on the CPU.

The tiny GAN config of tests/test_train.py, but with MODEL.VSSM.DIMS 16, so
that the encoder and decoder stages take the fused scan (K·D ≥ 128) and the
two narrow head stages the recurrence (K·D 64 and 8): both scan routes run
forward and backward. DROP_PATH_RATE is 0 (the two frameworks draw different
bits); fp32. The JAX generator and MPD are initialised once, carried to the
port by the compat converters, and one step runs on each side from the same
state and batch. The JAX step is compiled once for the module.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.models import get_model
from vm_asr_tpu.train.optim import make_optimizer as jax_make_optimizer
from vm_asr_tpu.train.states import DiscState as JaxDiscState
from vm_asr_tpu.train.states import GenState as JaxGenState
from vm_asr_tpu.train.steps import make_train_step as jax_make_train_step
from vm_asr_tpu_torch.compat import flax_disc_variables_to_state_dict, flax_params_to_state_dict
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.models import (
    DropPath,
    DualStreamInteractiveMambaUNet,
    generator_kwargs,
    get_discriminators,
)
from vm_asr_tpu_torch.train import DiscState, GenState, make_eval_step, make_optimizer, make_train_step

# Metrics: the same fp32 maths in other orders (~1e-7 rel observed).
METRIC_REL = 1e-4
# Generator gradient, per tensor: 1e-3 of that tensor's largest |gradient|,
# plus 1e-9 of the largest over all tensors. Some SS2D tensors of the narrow
# head (dt_projs, A_logs) get gradients 1e-6..1e-14 of the largest: sums that
# cancel to fp32 rounding noise, which the floor covers (observed ≤ 3e-10
# of it) and which no tensor above 1e-6 of the largest can hide behind.
GRAD_REL, GRAD_FLOOR = 1e-3, 1e-9
# Spectral-norm u and sigma after the step: one power iteration on the same
# weights (≤ 5e-7 rel observed).
STATS_REL = 1e-5
STEPS_PER_EPOCH = 10
LR = 1e-3  # BASE_LR at update 0: cosine schedule, no warm-up
T, B = 2016, 2


def _tiny(c):
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = 0.126  # 2016 samples → 64-frame spectral image
    c.DATA.STFT.N_FFT = 128
    c.DATA.STFT.HOP_LENGTH = 32
    c.DATA.STFT.WIN_LENGTH = 128
    c.MODEL.NAME = "DualStreamInteractiveMambaUNet"
    c.MODEL.VSSM.DIMS = 16
    c.MODEL.VSSM.DEPTHS = [1, 1, 1, 1]
    c.MODEL.VSSM.DROP_PATH_RATE = 0.0
    c.TRAIN.EPOCHS = 1
    c.TRAIN.WARMUP_EPOCHS = 0
    c.TRAIN.LOW_FREQ_REPLACEMENT = True
    c.TRAIN.ADVERSARIAL.ENABLE = True
    c.TRAIN.ADVERSARIAL.DISCRIMINATORS = ["mpd"]
    c.TRAIN.ADVERSARIAL.MPD_HIDDEN = 2
    c.TRAIN.ADVERSARIAL.MPD_PERIODS = [2, 3]
    c.DTYPE.COMPUTE = "float32"
    c.AMP_ENABLE = False
    return c


def _batch():
    """Input with the Nyquist offset and zeroed boundaries of
    tests/test_torch_model.py (angle() of the exactly-real bins then agrees
    between the two FFTs); a random target; two highcut bins."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 1, T))
    x = x + (np.abs(x).max() + 1.0) * (-1.0) ** np.arange(T)
    x[..., :128] = 0.0
    x[..., -128:] = 0.0
    y = 0.3 * rng.standard_normal((B, 1, T))
    return (0.1 * x).astype(np.float32), y.astype(np.float32), np.array([16, 40], np.int32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_models(cfg, gen_params, disc_vars):
    model = DualStreamInteractiveMambaUNet(**generator_kwargs(cfg))
    model.load_state_dict(flax_params_to_state_dict(gen_params), strict=True)
    mpd = get_discriminators(cfg, "cpu").get("mpd")
    if mpd is not None:
        mpd.load_state_dict(flax_disc_variables_to_state_dict(disc_vars), strict=True)
    return model, mpd


@pytest.fixture(scope="module")
def jax_run():
    """Initial variables, the generator gradient, and one JAX train step."""
    cfg = _tiny(jax_default_config())
    models = get_model(cfg)
    gen, mpd = models["generator"], models["mpd"]
    x, y, hf = _batch()
    key = jax.random.PRNGKey(0)
    gvars = _np(jax.jit(gen.init)({"params": key, "dropout": key}, jnp.asarray(x),
                                  jnp.asarray(hf)))
    dvars = _np(jax.jit(mpd.init)(jax.random.PRNGKey(1), jnp.asarray(y), jnp.asarray(y)))
    gs = JaxGenState.create(jax.tree_util.tree_map(jnp.asarray, gvars["params"]),
                            jax_make_optimizer(cfg, STEPS_PER_EPOCH))
    ds = {"mpd": JaxDiscState.create(jax.tree_util.tree_map(jnp.asarray, dvars),
                                     jax_make_optimizer(cfg, STEPS_PER_EPOCH))}
    step = jax_make_train_step(cfg, gen, {"mpd": mpd})
    batch = {"wave_input": jnp.asarray(x), "wave_target": jnp.asarray(y),
             "highcut": jnp.asarray(hf)}
    rng = jax.random.PRNGKey(5)

    @jax.jit
    def grads_and_step(gs, ds):
        grads = jax.grad(lambda p: step.gen_loss_fn(p, ds, *batch.values(), rng)[0])(gs.params)
        return grads, step(gs, ds, batch, rng)

    grads, (gs2, ds2, metrics) = grads_and_step(gs, ds)
    return dict(
        gvars=gvars, dvars=dvars, grads=_np(grads), params=_np(gs2.params),
        disc_after={"params": _np(ds2["mpd"].params), "batch_stats": _np(ds2["mpd"].batch_stats)},
        metrics={k: float(v) for k, v in metrics.items()},
    )


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's generator gradient and one train step from the same state,
    with the launch counts of the scan wrappers (CPU: their plain versions
    inside the same autograd Functions)."""
    cfg = _tiny(default_config())
    model, mpd = _port_models(cfg, jax_run["gvars"]["params"], jax_run["dvars"])
    step = make_train_step(cfg, model, {"mpd": mpd})
    x, y, hf = (torch.from_numpy(a) for a in _batch())
    batch = {"wave_input": x, "wave_target": y, "highcut": hf.long()}
    rng = torch.Generator().manual_seed(0)
    total, _, _ = step.gen_loss_fn(x, y, batch["highcut"], rng)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(total, [p for _, p in named])
    gen_state = GenState(model, make_optimizer(cfg, STEPS_PER_EPOCH, model))
    disc_states = {"mpd": DiscState(mpd, make_optimizer(cfg, STEPS_PER_EPOCH, mpd))}
    _, _, metrics = step(gen_state, disc_states, batch, rng)
    return dict(grads={n: g for (n, _), g in zip(named, grads)}, model=model, mpd=mpd,
                metrics={k: float(v) for k, v in metrics.items()}, gen_state=gen_state,
                disc_states=disc_states)


def test_metrics_match_jax(jax_run, port_run):
    ref, got = jax_run["metrics"], port_run["metrics"]
    assert set(got) == set(ref)
    assert {"total_loss", "generator/multi_resolution_stft", "generator/adversarial_mpd",
            "generator/features_mpd", "discriminator/mpd", "disc_gap/mpd",
            "disc_gap/mpd_max", "total_disc_loss", "snr", "lsd", "lsd_hf", "lsd_lf"} <= set(got)
    for k in ref:
        assert abs(got[k] - ref[k]) <= METRIC_REL * abs(ref[k]), (k, got[k], ref[k])


def test_generator_gradient_matches_jax(jax_run, port_run):
    ref = flax_params_to_state_dict(jax_run["grads"])
    got = port_run["grads"]
    assert set(got) == set(ref)
    top = max(float(v.abs().max()) for v in ref.values())
    for name, r in ref.items():
        err = float((got[name] - r).abs().max())
        assert err <= GRAD_REL * float(r.abs().max()) + GRAD_FLOOR * top, (name, err)
    # Every SS2D parameter of both routes gets a gradient (a scan wrapper
    # that dropped it would leave zeros).
    for name, g in got.items():
        if ".op." in name:
            assert float(g.abs().max()) > 0, name


def test_params_after_step_match_jax(jax_run, port_run):
    """AdamW's first update is lr·g/(|g| + eps) ≈ ±lr per element, so a
    gradient that is fp32 noise around 0 can step either way: elements may
    differ by up to 2·lr, but only a few of them may differ at all."""
    ref = flax_params_to_state_dict(jax_run["params"])
    got = port_run["model"].state_dict()
    diff = np.concatenate([(got[k] - ref[k]).abs().numpy().ravel() for k in ref]) / LR
    assert diff.max() <= 2.0 + 1e-3
    assert (diff > 0.01).mean() <= 1e-3
    moved = np.concatenate([(got[k] - v).abs().numpy().ravel() for k, v in
                            flax_params_to_state_dict(jax_run["gvars"]["params"]).items()])
    assert np.median(moved) > 0.5 * LR  # the step did update the parameters


def test_discriminator_after_step_matches_jax(jax_run, port_run):
    ref = flax_disc_variables_to_state_dict(jax_run["disc_after"])
    got = port_run["mpd"].state_dict()
    assert set(got) == set(ref)
    for k, r in ref.items():
        err = float((got[k] - r).abs().max())
        if k.endswith((".u", ".sigma")):
            assert err <= STATS_REL * float(r.abs().max()), (k, err)
        else:
            assert err <= 0.01 * LR, (k, err)
    assert port_run["gen_state"].step == 1 and port_run["disc_states"]["mpd"].step == 1
    assert port_run["gen_state"].optimizer.count == 1


def test_eval_step_metrics(port_run):
    """make_eval_step: eval-mode forward and the same metric names, without
    updates."""
    cfg = _tiny(default_config())
    model = port_run["model"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x, y, hf = (torch.from_numpy(a) for a in _batch())
    wave, metrics = make_eval_step(cfg, model)({"wave_input": x, "wave_target": y,
                                                "highcut": hf.long()})
    assert wave.shape == x.shape and torch.isfinite(wave).all()
    assert {"total_loss", "generator/multi_resolution_stft", "snr", "lsd"} <= set(metrics)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_train_step_takes_both_scan_routes(jax_run, monkeypatch):
    """One port step runs the fused scan and the recurrence, forward and
    backward (on the CPU through the same autograd Functions)."""
    calls = {"fused_bwd": 0, "lr_reverse": 0}

    def spy(module, attr, key):
        fn = getattr(module, attr)

        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, attr, wrapped)

    spy(importlib.import_module("vm_asr_tpu_torch.ops.selective_scan_fused"),
        "selective_scan_fused_bwd", "fused_bwd")
    spy(importlib.import_module("vm_asr_tpu_torch.ops.linear_recurrence"),
        "linear_recurrence_reverse", "lr_reverse")
    cfg = _tiny(default_config())
    cfg.TRAIN.ADVERSARIAL.ENABLE = False
    model, _ = _port_models(cfg, jax_run["gvars"]["params"], jax_run["dvars"])
    x, y, hf = (torch.from_numpy(a) for a in _batch())
    step = make_train_step(cfg, model, {})
    step(GenState(model, make_optimizer(cfg, STEPS_PER_EPOCH, model)), {},
         {"wave_input": x, "wave_target": y, "highcut": hf.long()}, torch.Generator())
    # Depths 1-1-1-1, two streams, each through 8 fused SS2Ds (4 encoder
    # stages, 3 decoder stages with blocks, out_vss1) and 2 on the
    # recurrence (out_vss2, out_vss3).
    assert calls == {"fused_bwd": 16, "lr_reverse": 4}


def test_drop_path_law_and_seeding():
    """DropPath keeps a sample with probability 1 − rate and scales it by
    1/keep; the same generator seed gives the same mask; in training it
    refuses to draw without a generator."""
    dp = DropPath(0.25).train()
    x = torch.ones(20000, 3, 2)
    out = dp(x, torch.Generator().manual_seed(7))
    kept = out[:, 0, 0] != 0
    assert torch.equal(out[kept], torch.full_like(out[kept], 1 / 0.75))
    assert torch.all(out[~kept] == 0)
    assert abs(kept.float().mean().item() - 0.75) < 0.01  # ±4 sd of 20000 draws
    again = dp(x, torch.Generator().manual_seed(7))
    assert torch.equal(out, again)
    assert not torch.equal(out, dp(x, torch.Generator().manual_seed(8)))
    with pytest.raises(ValueError, match="Generator"):
        dp(x)
    assert torch.equal(dp.eval()(x), x)


def test_drop_path_through_the_model(jax_run):
    """With DROP_PATH_RATE 0.1 a training-mode forward draws its masks from
    the generator passed in: two forwards with the same seed agree, another
    seed differs, and eval mode ignores it."""
    cfg = _tiny(default_config())
    cfg.MODEL.VSSM.DROP_PATH_RATE = 0.1
    model, _ = _port_models(cfg, jax_run["gvars"]["params"], jax_run["dvars"])
    x, _, hf = (torch.from_numpy(a) for a in _batch())
    x, hf = x.repeat(4, 1, 1), hf.long().repeat(4)
    model.train()
    with torch.no_grad():
        a = model(x, hf, generator=torch.Generator().manual_seed(1))
        b = model(x, hf, generator=torch.Generator().manual_seed(1))
        c = model(x, hf, generator=torch.Generator().manual_seed(2))
        model.eval()
        e = model(x, hf)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert not torch.equal(a, e)


def test_wgan_gp_step_is_not_ported_yet():
    """The gradient penalty's discriminator step, refused until it was
    ported, now builds; its interpolation weights come from the step's
    generator, one set per discriminator (the step itself is held to the
    JAX package's in tests/test_torch_gan_options.py)."""
    cfg = _tiny(default_config())
    cfg.TRAIN.ADVERSARIAL.GAN_LOSS_TYPE = "wgan-gp"
    drawn = []
    step = make_train_step(cfg, torch.nn.Identity(), {"mpd": torch.nn.Identity()},
                           gp_alpha=lambda rng, b, n: drawn.append((b, n)))
    assert callable(step) and callable(step.gen_loss_fn) and drawn == []
