"""scripts/jax_checkpoint_to_pth.py on the CPU: a JAX run's orbax checkpoints
become the port's ``.pth`` files, which the port then loads as its own.

A tiny JAX run (the config of tests/test_torch_trainer.py: DIMS 8, the L2
loss, the MPD, AdamW with weight decay) trains two epochs and saves
`latest`, `best` and a copy of each epoch; the script converts the run
folder. Then:
- every generator and MPD tensor (spectral-norm u and sigma too), both AdamW
  moments, the update count, the step, the epoch and monitor_best are the
  JAX checkpoint's, bit for bit;
- the port's generator from the converted `best`, loaded as --eval and
  --inference load it, gives bitwise the forward of the JAX params carried
  over in memory by ``flax_params_to_state_dict``, and its fp32 forward is
  within 1e-5 relative of the JAX package's jitted forward (the forward its
  Tester and Inferencer run). That bar sits at fp32 rounding for this model:
  the two frameworks' forwards of the same weights differ by 2e-6 to 1.5e-5
  relative over inputs and weights, and JAX's eager forward differs from its
  jitted one by up to 8e-6;
- a second epoch resumed by the port's Trainer from the converted epoch-0
  checkpoint logs within 2e-5 of the JAX Trainer's second epoch
  (tests/test_torch_trainer.py's bar).
"""

import importlib.util
import math
import shutil
from pathlib import Path

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
from vm_asr_tpu_torch import cli
from vm_asr_tpu_torch.compat import flax_disc_variables_to_state_dict, flax_params_to_state_dict
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.core.logging import create_logger
from vm_asr_tpu_torch.data import DataPipeline, DegradingSampler
from vm_asr_tpu_torch.models import get_generator
from vm_asr_tpu_torch.train import Trainer as PortTrainer
from vm_asr_tpu_torch.train import make_optimizer
from tests.test_torch_trainer import LOG_REL, _adam_state, _loaders, _port_models, _tiny
from tests.torch_native import jax_uses_port_native  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FORWARD_REL = 1e-5

_spec = importlib.util.spec_from_file_location(
    "jax_checkpoint_to_pth", ROOT / "scripts" / "jax_checkpoint_to_pth.py")
script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(script)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two JAX epochs saved as orbax checkpoints (latest, best, and a copy of
    each epoch), converted by the script; the JAX train state at the end of
    epoch 0 is kept in memory."""
    tmp = tmp_path_factory.mktemp("jaxrun")
    jcfg = _tiny(jax_default_config(), tmp / "jax", epochs=2)
    jcfg.SAVE_EPOCH_FREQ = 1
    trainer = JaxTrainer(jcfg, get_model(jcfg), *_loaders(jcfg, JaxDegradingSampler,
                                                          JaxDataPipeline), mesh=make_mesh(1))
    kept, save = {}, trainer._save

    def keep(epoch, best):
        kept.setdefault(epoch, (_np(trainer.gen_state), {k: _np(v) for k, v in
                                                          trainer.disc_states.items()}))
        save(epoch, best)

    trainer._save = keep
    trainer.train()
    written = script.convert_run(str(tmp / "jax"), str(tmp / "port"))
    return dict(tmp=tmp, trainer=trainer, written=written, epoch0=kept[0])


def test_script_writes_every_kind_and_model(run):
    names = sorted(Path(p).name for p in run["written"])
    assert names == [f"checkpoint-{k}-{m}.pth" for k in ("best", "epoch-0", "epoch-1", "latest")
                     for m in ("G", "mpd")]
    # In place, beside the orbax folders, by the command line.
    assert script.main([str(run["tmp"] / "jax")]) == 0
    assert sorted(p.name for p in (run["tmp"] / "jax").glob("*.pth")) == names


@pytest.mark.parametrize("kind", ["latest", "best", "epoch-0"])
@pytest.mark.parametrize("tag", ["G", "mpd"])
def test_converted_checkpoint_bitwise(run, kind, tag):
    jtr = run["trainer"]
    target = jtr.gen_state if tag == "G" else jtr.disc_states[tag]
    restored = jtr.ckpt.restore(tag, kind, target=jax.device_get(target))
    ref = _np(restored["state"])
    adam = _adam_state(ref.opt_state)
    if tag == "G":
        convert = flax_params_to_state_dict
        ref_sd = convert(ref.params)
    else:
        def convert(t):
            return flax_disc_variables_to_state_dict({"params": t})
        ref_sd = flax_disc_variables_to_state_dict(
            {"params": ref.params, "batch_stats": ref.batch_stats})
    assert any(k.endswith(".sigma") for k in ref_sd) == (tag == "mpd")

    blob = torch.load(run["tmp"] / "port" / f"checkpoint-{kind}-{tag}.pth", weights_only=True)
    assert set(blob) == {"state_dict", "optimizer", "step", "epoch", "monitor_best", "config"}
    assert (blob["step"], blob["epoch"]) == (int(ref.step), restored["epoch"])
    assert blob["step"] == 3 * (blob["epoch"] + 1) and blob["epoch"] == (kind != "epoch-0")
    assert blob["monitor_best"] == restored["monitor_best"]
    assert math.isfinite(blob["monitor_best"])
    assert (blob["config"] is None) == (tag != "G")
    assert set(blob["state_dict"]) == set(ref_sd)
    for k, v in ref_sd.items():
        assert blob["state_dict"][k].dtype == torch.float32
        assert torch.equal(blob["state_dict"][k], v), k

    # The moments, by parameter name through the port's own optimizer.
    cfg = _tiny(default_config(), run["tmp"] / "unused")
    module = _port_models(cfg)["generator" if tag == "G" else tag]
    opt = make_optimizer(cfg, 1, module)
    names = {id(p): n for n, p in module.named_parameters()}
    order = [names[id(p)] for g in opt.tx.param_groups for p in g["params"]]
    saved = blob["optimizer"]
    assert (saved["count"], saved["mini_step"], saved["acc"]) == (int(adam.count), 0, None)
    mu, nu = convert(adam.mu), convert(adam.nu)
    assert len(saved["tx"]["state"]) == len(order) == len(mu)
    for i, s in saved["tx"]["state"].items():
        assert int(s["step"]) == int(adam.count) == blob["step"]
        assert torch.equal(s["exp_avg"], mu[order[i]]), order[i]
        assert torch.equal(s["exp_avg_sq"], nu[order[i]]), order[i]


def test_converted_forward_matches_jax(run):
    """The converted `best` generator, loaded as the port's --eval and
    --inference load it, against the same weights carried over in memory
    and against the JAX package's jitted forward of the orbax params."""
    jtr = run["trainer"]
    params = _np(jtr.ckpt.restore("G", "best", target=jax.device_get(jtr.gen_state))
                 ["state"].params)
    cfg = _tiny(default_config(), run["tmp"] / "port")
    cfg.MODEL.RESUME_PATH = str(run["tmp"] / "port")
    gen = get_generator(cfg, "cpu", seed=99)  # other weights until loaded
    cli.load_generator_weights(cfg, gen, create_logger(str(run["tmp"] / "logs")))
    rng = np.random.default_rng(2)
    t = 2016
    x = rng.standard_normal((2, 1, t))
    x = x + (np.abs(x).max() + 1.0) * (-1.0) ** np.arange(t)
    x[..., :128] = x[..., -128:] = 0.0
    x = x.astype(np.float32)
    hf = np.array([10, 40])
    direct = get_generator(cfg, "cpu")
    direct.load_state_dict(flax_params_to_state_dict(params), strict=True)
    with torch.inference_mode():
        got = gen(torch.from_numpy(x), torch.from_numpy(hf)).numpy()
        np.testing.assert_array_equal(got, direct(torch.from_numpy(x),
                                                  torch.from_numpy(hf)).numpy())
    ref = np.asarray(jax.jit(jtr.generator.apply)({"params": params}, x, hf))
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert got.shape == ref.shape == x.shape and rel < FORWARD_REL, rel


def test_resumed_epoch_matches_jax(run, tmp_path):
    """Epoch 1 resumed by the port's Trainer from the converted epoch-0
    checkpoints, against the JAX Trainer's epoch 1, which started from the
    state its epoch-0 checkpoint holds (checked bit for bit: a JAX resume
    from that checkpoint would start from the same state)."""
    jtr = run["trainer"]
    gen0, discs0 = run["epoch0"]
    for tag, state in [("G", gen0)] + list(discs0.items()):
        restored = _np(jtr.ckpt.restore(tag, "epoch-0", target=state)["state"])
        for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(state)):
            np.testing.assert_array_equal(a, b)
    for tag in ("G", "mpd"):
        shutil.copy(run["tmp"] / "port" / f"checkpoint-epoch-0-{tag}.pth",
                    tmp_path / f"checkpoint-latest-{tag}.pth")

    cfg = _tiny(default_config(), tmp_path, epochs=2)
    cfg.MODEL.RESUME_PATH = str(tmp_path)
    ptr = PortTrainer(cfg, _port_models(cfg), *_loaders(cfg, DegradingSampler, DataPipeline))
    assert ptr.start_epoch == 1 and ptr.gen_state.step == 3
    ptr.train()
    assert [t["epoch"] for t in ptr.timings] == [1]
    assert ptr.gen_state.optimizer.count == 6
    for which in ("train", "valid"):
        got = getattr(ptr, f"{which}_metrics").result()
        ref = getattr(jtr, f"{which}_metrics").result()
        assert set(got) == set(ref)
        bad = {k: (got[k], ref[k]) for k in ref
               if not abs(got[k] - ref[k]) <= LOG_REL * _scale(ref, k)}
        assert not bad, (which, bad)


def _scale(log, key):
    """What a log is held relative to: itself, except ``disc_gap/<name>``
    and ``disc_gap/<name>_max``. Each sub-discriminator's gap is mean
    D(real) − mean D(fake), a difference of two scores of the size of
    √(discriminator loss) (~1.35 here) that cancels to ~1e-5..1e-4 in this
    epoch; ``disc_gap/<name>`` is the gaps' mean and ``disc_gap/<name>_max``
    their largest magnitude. fp32 rounding of the scores moves each gap by
    a few ulps of the scores (~1e-7 of 1.35), so it moves their mean, and
    their largest magnitude (which is one of the gaps), by as much: ~1e-4 of
    the cancelled values themselves (observed 1.05e-4 for the mean, 2.8e-9
    absolute, and 1.45e-4 for the max, 9.4e-9 absolute). Both are held
    relative to the scores' size, √(discriminator loss), instead:
    test_discriminator_scores_match_jax holds the scores themselves to
    their fp32 rounding. A fault in the discriminator's weights or moments
    shows in ``discriminator/<name>`` and ``generator/adversarial_<name>``,
    held to 2e-5 of themselves."""
    name = key.partition("/")[2].removesuffix("_max")
    if key.startswith("disc_gap/"):
        return max(abs(log[key]), math.sqrt(log[f"discriminator/{name}"]))
    return abs(log[key])


# Each sub-discriminator's mean score, the port's against JAX's from the
# same weights and input: a few fp32 ulps of the scores' size (observed
# SCORE_OBSERVED of it).
SCORE_REL = 1e-6


def test_discriminator_scores_match_jax(run):
    """The scores the gaps are made of: the port's MPD from the JAX
    epoch-0 checkpoint's variables, on the same real and fake batch as the
    JAX MPD, each sub-discriminator's mean D(real) and mean D(fake) within
    SCORE_REL of the scores' size, and so each gap, and the gaps' mean and
    largest magnitude, within twice that."""
    _, discs0 = run["epoch0"]
    variables = {"params": discs0["mpd"].params, "batch_stats": discs0["mpd"].batch_stats}
    cfg = _tiny(default_config(), run["tmp"] / "scores")
    mpd = _port_models(cfg)["mpd"]
    mpd.load_state_dict(flax_disc_variables_to_state_dict(variables), strict=True)
    jmpd = get_model(_tiny(jax_default_config(), run["tmp"] / "scores"))["mpd"]
    rng = np.random.default_rng(4)
    real, fake = (0.3 * rng.standard_normal((4, 1, 2016))).astype(np.float32), \
        (0.3 * rng.standard_normal((4, 1, 2016))).astype(np.float32)
    y_r, y_g, _, _ = jax.jit(lambda v, a, b: jmpd.apply(v, a, b, update_stats=False))(
        variables, real, fake)
    with torch.no_grad():
        p_r, p_g, _, _ = mpd(torch.from_numpy(real), torch.from_numpy(fake), update_stats=False)
    ref = np.array([[float(np.mean(r)), float(np.mean(g))] for r, g in zip(y_r, y_g)])
    got = np.array([[float(r.mean()), float(g.mean())] for r, g in zip(p_r, p_g)])
    scale = np.abs(ref).max()
    assert got.shape == ref.shape == (len(cfg.TRAIN.ADVERSARIAL.MPD_PERIODS), 2)
    assert np.abs(got - ref).max() <= SCORE_REL * scale, (np.abs(got - ref).max() / scale)
    gaps, ref_gaps = got[:, 0] - got[:, 1], ref[:, 0] - ref[:, 1]
    assert np.abs(gaps - ref_gaps).max() <= 2 * SCORE_REL * scale
    assert abs(np.abs(gaps).max() - np.abs(ref_gaps).max()) <= 2 * SCORE_REL * scale
