"""The port's GAN train step of the single-stream generator (INTERACT
single, configs/vm_asr_48k_MPD_SINGLE.yaml) against the JAX package's
make_train_step, on the CPU: the set-up and bars of
tests/test_torch_train_step.py (the tiny GAN config at dims 16, DropPath 0,
fp32), with the phase stream gone. The JAX step is compiled once for the
module."""

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
from vm_asr_tpu_torch.compat import flax_params_to_state_dict
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.train import DiscState, GenState, make_optimizer, make_train_step
from tests.test_torch_train_step import (
    GRAD_FLOOR,
    GRAD_REL,
    LR,
    METRIC_REL,
    STEPS_PER_EPOCH,
    _batch,
    _np,
    _port_models,
    _tiny,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _single(c):
    c = _tiny(c)
    c.MODEL.VSSM.INTERACT = "single"
    return c


@pytest.fixture(scope="module")
def runs():
    """One JAX step and its generator gradient, then the port's from the
    same variables and batch."""
    cfg = _single(jax_default_config())
    models = get_model(cfg)
    gen, mpd = models["generator"], models["mpd"]
    x, y, hf = _batch()
    key = jax.random.PRNGKey(0)
    gvars = _np(jax.jit(gen.init)({"params": key, "dropout": key}, jnp.asarray(x),
                                  jnp.asarray(hf)))
    assert set(gvars["params"]) == {"core_mag"}
    dvars = _np(jax.jit(mpd.init)(jax.random.PRNGKey(1), jnp.asarray(y), jnp.asarray(y)))
    gs = JaxGenState.create(jax.tree_util.tree_map(jnp.asarray, gvars["params"]),
                            jax_make_optimizer(cfg, STEPS_PER_EPOCH))
    ds = {"mpd": JaxDiscState.create(jax.tree_util.tree_map(jnp.asarray, dvars),
                                     jax_make_optimizer(cfg, STEPS_PER_EPOCH))}
    jstep = jax_make_train_step(cfg, gen, {"mpd": mpd})
    jbatch = {"wave_input": jnp.asarray(x), "wave_target": jnp.asarray(y),
              "highcut": jnp.asarray(hf)}
    rng = jax.random.PRNGKey(5)

    @jax.jit
    def grads_and_step(gs, ds):
        grads = jax.grad(lambda p: jstep.gen_loss_fn(p, ds, *jbatch.values(), rng)[0])(
            gs.params)
        return grads, jstep(gs, ds, jbatch, rng)

    grads, (gs2, _, metrics) = grads_and_step(gs, ds)

    pcfg = _single(default_config())
    model, pmpd = _port_models(pcfg, gvars["params"], dvars)
    step = make_train_step(pcfg, model, {"mpd": pmpd})
    xt, yt, hft = (torch.from_numpy(a) for a in _batch())
    batch = {"wave_input": xt, "wave_target": yt, "highcut": hft.long()}
    trng = torch.Generator().manual_seed(0)
    total, _, _ = step.gen_loss_fn(xt, yt, batch["highcut"], trng)
    named = list(model.named_parameters())
    pgrads = torch.autograd.grad(total, [p for _, p in named])
    gen_state = GenState(model, make_optimizer(pcfg, STEPS_PER_EPOCH, model))
    disc_states = {"mpd": DiscState(pmpd, make_optimizer(pcfg, STEPS_PER_EPOCH, pmpd))}
    _, _, pmetrics = step(gen_state, disc_states, batch, trng)
    return dict(
        jax_grads=_np(grads), jax_params=_np(gs2.params), gvars=gvars, dvars=dvars,
        jax_metrics={k: float(v) for k, v in metrics.items()},
        grads={n: g for (n, _), g in zip(named, pgrads)}, model=model,
        metrics={k: float(v) for k, v in pmetrics.items()})


def test_single_metrics_match_jax(runs):
    ref, got = runs["jax_metrics"], runs["metrics"]
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= METRIC_REL * abs(ref[k]), (k, got[k], ref[k])


def test_single_generator_gradient_matches_jax(runs):
    ref = flax_params_to_state_dict(runs["jax_grads"])
    got = runs["grads"]
    assert set(got) == set(ref)
    assert not any("_phase" in k for k in got)
    top = max(float(v.abs().max()) for v in ref.values())
    for name, r in ref.items():
        err = float((got[name] - r).abs().max())
        assert err <= GRAD_REL * float(r.abs().max()) + GRAD_FLOOR * top, (name, err)
    for name, g in got.items():
        if ".op." in name:
            assert float(g.abs().max()) > 0, name


def test_single_params_after_step_match_jax(runs):
    """As tests/test_torch_train_step.py: AdamW's first update is about ±lr
    per element, so elements may differ by up to 2·lr where the gradient is
    fp32 noise, but only a few may differ at all."""
    ref = flax_params_to_state_dict(runs["jax_params"])
    got = runs["model"].state_dict()
    diff = np.concatenate([(got[k] - ref[k]).abs().numpy().ravel() for k in ref]) / LR
    assert diff.max() <= 2.0 + 1e-3
    assert (diff > 0.01).mean() <= 1e-3


def test_single_step_takes_half_the_scans(runs, monkeypatch):
    """The single-stream step runs the scans of one stream: 8 fused SS2Ds
    (4 encoder stages, 3 decoder stages with blocks, out_vss1) and 2 on the
    recurrence (out_vss2, out_vss3), forward and backward: half the dual
    step's 16 + 4."""
    calls = {"fused": 0, "fused_bwd": 0, "lr": 0, "lr_reverse": 0}
    fused = importlib.import_module("vm_asr_tpu_torch.ops.selective_scan_fused")
    lr = importlib.import_module("vm_asr_tpu_torch.ops.linear_recurrence")
    for module, attr, key in ((fused, "selective_scan_fused_plain", "fused"),
                              (fused, "selective_scan_fused_bwd", "fused_bwd"),
                              (lr, "linear_recurrence_plain", "lr"),
                              (lr, "linear_recurrence_reverse", "lr_reverse")):
        fn = getattr(module, attr)
        monkeypatch.setattr(module, attr, lambda *a, _fn=fn, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _fn(*a, **kw))[1])
    cfg = _single(default_config())
    cfg.TRAIN.ADVERSARIAL.ENABLE = False
    model, _ = _port_models(cfg, runs["gvars"]["params"], runs["dvars"])
    x, y, hf = (torch.from_numpy(a) for a in _batch())
    make_train_step(cfg, model, {})(
        GenState(model, make_optimizer(cfg, STEPS_PER_EPOCH, model)), {},
        {"wave_input": x, "wave_target": y, "highcut": hf.long()}, torch.Generator())
    assert calls == {"fused": 8, "fused_bwd": 8, "lr": 2, "lr_reverse": 2}
