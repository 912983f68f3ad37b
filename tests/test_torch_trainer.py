"""The port's Trainer (train/trainer.py) against the JAX package's, on the
CPU, and its loop on its own: early stopping, the NaN kill-switch, resume.

One epoch of GAN training with the MPD on each side (three AdamW updates
with weight decay), from the same initial weights (the JAX Trainer's,
carried over by the compat converters) and the same batches (each package's
own pipeline); then each side's last checkpoint is read back from disk and
held to the other's: every parameter, both AdamW moments and the counts.
DROP_PATH_RATE is 0, as the two frameworks draw different masks. The model's
input is the target itself (input rate = target rate) with the Nyquist
offset and zeroed ends of tests/test_torch_model.py::_wave: on a real signal
the exactly-real bins of a window's first frame have angle() +π in one FFT
and −π in the other, a difference the phase stream carries to the output.
(The pipelines are held bitwise equal on real degradation in
tests/test_torch_data.py.)

Two choices keep three updates comparable. DIMS is 8: at DIMS 4 the output
head's last LayerNorm spans one channel, so its output is its bias and every
gradient above it is exactly zero in JAX (fp32 noise in torch, which AdamW
turns into ±lr steps). The generator's loss is L2 on the waveform: with the
multi-resolution STFT loss this tiny model's trajectory is chaotic (the JAX
Trainer against itself, with 0.05 % of the initial weights moved by 2e-3,
ends the epoch with logs 4 % apart), so three updates could not tell a fault
from rounding. That loss's gradient is held to JAX's, for one step, in
tests/test_torch_train_step.py.
"""

import math

import numpy as np
import pytest
import torch

import jax

from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.data import DataPipeline as JaxDataPipeline
from vm_asr_tpu.data import DegradingSampler as JaxDegradingSampler
from vm_asr_tpu.models import get_model
from vm_asr_tpu.parallel import make_mesh
from vm_asr_tpu.train.trainer import Trainer as JaxTrainer
from vm_asr_tpu_torch.compat import flax_disc_variables_to_state_dict, flax_params_to_state_dict
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.data import DataPipeline, DegradingSampler, train_valid_split
from vm_asr_tpu_torch.models import get_discriminators, get_generator
from vm_asr_tpu_torch.train import Trainer as PortTrainer
from tests.torch_native import jax_uses_port_native  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

# The epoch's logs: means over the steps; observed ≤ 5.6e-6.
LOG_REL = 2e-5
# Parameters after the epoch, in units of LR. AdamW's update is
# lr·m/(√v + eps) ≈ ±lr where a gradient is fp32 noise around 0, so an
# element may differ by up to 2·(the sum of the three learning rates), but
# few may differ at all: observed 8.8e-5 of the elements beyond 0.01·LR and
# 9.4e-4 beyond 1e-3·LR. A wrong learning rate at any update moves nearly
# every element; weight decay (0.1·|w|·LR per update) missing, or applied
# where it must not be, moves most of the elements concerned by > 1e-3·LR.
PARAM_FAR, PARAM_FAR_SHARE = 0.01, 1e-3
PARAM_NEAR, PARAM_NEAR_SHARE = 1e-3, 5e-3
# AdamW's moments, per tensor, as a share of the tensor's largest |value|:
# observed ≤ 5.3e-4 (mu) and ≤ 8.0e-4 (nu).
MOMENT_REL = 5e-3
# The discriminator's spectral-norm u and sigma: observed ≤ 3.8e-7.
STATS_REL = 1e-5
SEG = 2016
LR = 1e-4
N_ITEMS = 16  # 12 train items: 3 steps at batch 4; 4 valid: one batch


def _tiny(c, out, epochs=1):
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = SEG / 16000
    c.DATA.STFT.N_FFT = 128
    c.DATA.STFT.HOP_LENGTH = 32
    c.DATA.STFT.WIN_LENGTH = 128
    c.DATA.RANDOM_RESAMPLE = [16000]
    c.DATA.BATCH_SIZE = 4
    c.DATA.NUM_WORKERS = 2
    c.MODEL.NAME = "DualStreamInteractiveMambaUNet"
    c.MODEL.VSSM.DIMS = 8
    c.MODEL.VSSM.DEPTHS = [1, 1, 1, 1]
    c.MODEL.VSSM.DROP_PATH_RATE = 0.0
    c.TRAIN.EPOCHS = epochs
    c.TRAIN.WARMUP_EPOCHS = 0
    c.TRAIN.BASE_LR = LR
    c.TRAIN.WEIGHT_DECAY = 0.1
    c.TRAIN.LOSSES.GEN = ["l2"]
    c.TRAIN.LOW_FREQ_REPLACEMENT = True
    c.TRAIN.ADVERSARIAL.ENABLE = True
    c.TRAIN.ADVERSARIAL.DISCRIMINATORS = ["mpd"]
    c.TRAIN.ADVERSARIAL.MPD_HIDDEN = 2
    c.TRAIN.ADVERSARIAL.MPD_PERIODS = [2, 3]
    c.MESH.DP = 1
    c.TENSORBOARD.ENABLE = False
    c.OUTPUT = str(out)
    c.DTYPE.COMPUTE = "float32"
    c.AMP_ENABLE = False
    return c


class Clips:
    """Segment-long clips with the Nyquist offset and zeroed ends."""

    def __init__(self, n):
        rng = np.random.default_rng(11)
        self.items = []
        for i in range(n):
            x = rng.uniform(-0.1, 0.1, SEG) + 0.2 * (-1.0) ** np.arange(SEG)
            x[:128] = x[-128:] = 0.0
            self.items.append((x.astype(np.float32), 16000, f"clip_{i}.wav"))

    def __len__(self):
        return len(self.items)

    def load(self, i):
        return self.items[i]


def _loaders(cfg, sampler_cls, pipeline_cls):
    sampler = sampler_cls(Clips(N_ITEMS), cfg, training=True)
    tr, va = train_valid_split(N_ITEMS, 0.25)
    kw = dict(batch_size=cfg.DATA.BATCH_SIZE, num_workers=2, seed=cfg.SEED)
    return (pipeline_cls(sampler, indices=tr, shuffle=True, **kw),
            pipeline_cls(sampler, indices=va, shuffle=False, **kw))


def _port_models(cfg, gen_params=None, disc_vars=None):
    gen = get_generator(cfg, "cpu")
    mpd = get_discriminators(cfg, "cpu")["mpd"]
    if gen_params is not None:
        gen.load_state_dict(flax_params_to_state_dict(gen_params), strict=True)
        mpd.load_state_dict(flax_disc_variables_to_state_dict(disc_vars), strict=True)
    return {"generator": gen, "mpd": mpd}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """One epoch of the JAX Trainer, then one of the port's from the JAX
    Trainer's initial weights."""
    tmp = tmp_path_factory.mktemp("trainer")
    jcfg = _tiny(jax_default_config(), tmp / "jax")
    jtr = JaxTrainer(jcfg, get_model(jcfg), *_loaders(jcfg, JaxDegradingSampler,
                                                      JaxDataPipeline), mesh=make_mesh(1))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa: E731
    gen_params = np_tree(jtr.gen_state.params)
    ds = jtr.disc_states["mpd"]
    disc_vars = {"params": np_tree(ds.params), "batch_stats": np_tree(ds.batch_stats)}
    jbest = jtr.train()

    cfg = _tiny(default_config(), tmp / "port")
    ptr = PortTrainer(cfg, _port_models(cfg, gen_params, disc_vars),
                      *_loaders(cfg, DegradingSampler, DataPipeline))
    pbest = ptr.train()
    return dict(jax=jtr, port=ptr, jax_best=jbest, port_best=pbest, tmp=tmp)


@pytest.mark.parametrize("which", ["train", "valid"])
def test_epoch_logs_match_jax(both, which):
    got = getattr(both["port"], f"{which}_metrics").result()
    ref = getattr(both["jax"], f"{which}_metrics").result()
    assert set(got) == set(ref) and len(got) >= (12 if which == "train" else 6)
    bad = {k: (got[k], ref[k]) for k in ref
           if not abs(got[k] - ref[k]) <= LOG_REL * abs(ref[k])}
    assert not bad, bad


def test_monitor_and_checkpoints_match_jax(both):
    assert both["port_best"] == pytest.approx(both["jax_best"], rel=LOG_REL)
    assert both["port_best"] == pytest.approx(both["port"].train_metrics.result()["lsd"])
    for tag in ("G", "mpd"):
        for kind in ("latest", "best"):
            assert both["jax"].ckpt.has(tag, kind) and both["port"].ckpt.has(tag, kind)
        got = both["port"].ckpt.load(tag, "latest")
        ref = both["jax"].ckpt.restore(tag, "latest")
        assert (got["epoch"], got["monitor_best"]) == pytest.approx(
            (ref["epoch"], ref["monitor_best"]), rel=LOG_REL)
        assert got["step"] == 3 and got["optimizer"]["count"] == 3
    assert both["port"].timings[0]["steps"] == 3


def _adam_state(opt_state):
    """optax.adamw's ScaleByAdamState (count, mu, nu)."""
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
    return next(x for x in leaves if hasattr(x, "mu"))


def _port_moments(blob, state):
    """{parameter name: (exp_avg, exp_avg_sq)} from a port checkpoint's
    AdamW state, whose entries are numbered across the parameter groups."""
    names = {id(p): n for n, p in state.module.named_parameters()}
    order = [names[id(p)] for g in state.optimizer.tx.param_groups for p in g["params"]]
    saved = blob["optimizer"]["tx"]
    assert [i for g in saved["param_groups"] for i in g["params"]] == list(range(len(order)))
    return {order[i]: (s["exp_avg"], s["exp_avg_sq"], int(s["step"]))
            for i, s in saved["state"].items()}


@pytest.mark.parametrize("tag", ["G", "mpd"])
def test_checkpoint_contents_match_jax(both, tag):
    """The epoch's last checkpoint of each model, read back from disk on each
    side: every parameter, both AdamW moments and the counts."""
    jtr, ptr = both["jax"], both["port"]
    target = jtr.gen_state if tag == "G" else jtr.disc_states[tag]
    ref = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jtr.ckpt.restore(tag, "latest", target=jax.device_get(target))["state"]))
    adam = _adam_state(ref.opt_state)
    if tag == "G":
        convert = flax_params_to_state_dict
        ref_sd = convert(ref.params)
    else:
        convert = lambda t: flax_disc_variables_to_state_dict({"params": t})  # noqa: E731
        ref_sd = flax_disc_variables_to_state_dict(
            {"params": ref.params, "batch_stats": ref.batch_stats})
    ref_mu, ref_nu = convert(adam.mu), convert(adam.nu)

    blob = ptr.ckpt.load(tag, "latest")
    state = ptr.gen_state if tag == "G" else ptr.disc_states[tag]
    got_sd, moments = blob["state_dict"], _port_moments(blob, state)
    assert set(got_sd) == set(ref_sd) and set(moments) == set(ref_mu)
    assert blob["step"] == int(ref.step) == 3
    assert blob["optimizer"]["count"] == int(adam.count) == 3
    assert {m[2] for m in moments.values()} == {3}

    lrs = [both["port"].gen_state.optimizer.schedule(n) for n in range(3)]
    params = [k for k in ref_sd if not k.endswith((".u", ".sigma"))]
    diff = np.concatenate([(got_sd[k] - ref_sd[k]).abs().numpy().ravel() for k in params]) / LR
    assert diff.max() <= 2 * sum(lrs) / LR + 1e-3
    assert (diff > PARAM_FAR).mean() <= PARAM_FAR_SHARE, (diff > PARAM_FAR).mean()
    assert (diff > PARAM_NEAR).mean() <= PARAM_NEAR_SHARE, (diff > PARAM_NEAR).mean()
    for k in set(ref_sd) - set(params):
        err = float((got_sd[k] - ref_sd[k]).abs().max())
        assert err <= STATS_REL * float(ref_sd[k].abs().max()), (k, err)
    for k, (mu, nu, _) in moments.items():
        for name, g, r in (("mu", mu, ref_mu[k]), ("nu", nu, ref_nu[k])):
            err = float((g - r).abs().max())
            assert err <= MOMENT_REL * float(r.abs().max()), (name, k, err)


def _fake_epochs(trainer, lsds):
    """Stand-in epochs that log the given training LSDs, one per epoch."""
    seen = []

    def train_epoch(epoch, timing):
        seen.append(epoch)
        return {"lsd": lsds[epoch], "total_loss": 1.0}

    trainer._train_epoch = train_epoch
    trainer._valid_epoch = lambda epoch: {"lsd": 9.0}
    return seen


def test_early_stopping(tmp_path):
    """EARLY_STOPPING 1: the run stops at the second epoch in a row without
    a better training LSD; only improving epochs write `best`."""
    cfg = _tiny(default_config(), tmp_path, epochs=6)
    cfg.TRAIN.EARLY_STOPPING = 1
    trainer = PortTrainer(cfg, _port_models(cfg), *_loaders(cfg, DegradingSampler,
                                                            DataPipeline))
    seen = _fake_epochs(trainer, [3.0, 2.0, 2.5, 2.4, 1.0, 0.5])
    assert trainer.train() == 2.0
    assert seen == [0, 1, 2, 3]
    assert trainer.ckpt.load("G", "best")["epoch"] == 1
    assert trainer.ckpt.load("G", "latest")["epoch"] == 2


def test_nan_kill_switch(tmp_path):
    cfg = _tiny(default_config(), tmp_path, epochs=3)
    trainer = PortTrainer(cfg, _port_models(cfg), *_loaders(cfg, DegradingSampler,
                                                            DataPipeline))
    _fake_epochs(trainer, [3.0, math.nan, 1.0])
    with pytest.raises(SystemExit) as e:
        trainer.train()
    assert e.value.code == 1
    assert trainer.ckpt.load("G", "latest")["epoch"] == 0


def test_resume_from_latest(tmp_path):
    """A second Trainer on the same OUTPUT resumes at the next epoch with
    the saved weights, optimizer count and monitor best, and goes on
    counting. The resumed epoch is profiled and writes TensorBoard
    artifacts."""
    cfg = _tiny(default_config(), tmp_path)
    first = PortTrainer(cfg, _port_models(cfg), *_loaders(cfg, DegradingSampler,
                                                          DataPipeline))
    best = first.train()
    saved = {k: v.clone() for k, v in first.generator.state_dict().items()}

    cfg2 = _tiny(default_config(), tmp_path, epochs=2)
    cfg2.PROFILE_STEPS = 1
    cfg2.TENSORBOARD.ENABLE = True
    models = _port_models(cfg2)
    second = PortTrainer(cfg2, models, *_loaders(cfg2, DegradingSampler, DataPipeline))
    assert second.start_epoch == 1 and second.mnt_best == best
    assert second.gen_state.optimizer.count == 3 and second.gen_state.step == 3
    assert second.disc_states["mpd"].optimizer.count == 3
    assert all(torch.equal(v, saved[k]) for k, v in models["generator"].state_dict().items())
    second.train()
    assert [t["epoch"] for t in second.timings] == [1]
    assert second.gen_state.optimizer.count == 6
    assert second.ckpt.load("G", "latest")["epoch"] == 1
    assert second.timings[0]["profile"]["steps"] == 1
    assert (tmp_path / "profile" / "trace.json.gz").is_file()
    assert list((tmp_path / "tb").iterdir()), "no TensorBoard events written"


def test_data_parallel_refused(tmp_path):
    """MESH.DP 2 in one process, outside a process group of two ranks: the
    Trainer refuses, saying how to start the ranks."""
    cfg = _tiny(default_config(), tmp_path)
    cfg.MESH.DP = 2
    with pytest.raises(ValueError, match="needs 2 ranks; 1 present"):
        PortTrainer(cfg, _port_models(cfg), *_loaders(cfg, DegradingSampler, DataPipeline))
