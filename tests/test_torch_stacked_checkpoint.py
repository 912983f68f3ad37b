"""scripts/jax_checkpoint_to_pth.py on a JAX run trained with MPD_STACKED
and the MSD, on the CPU: the stacked MPD's orbax tree (``group_g``
subtrees, each leaf with a leading lane axis) and the MSD's become the
port's unstacked ``.pth`` layout, weights, spectral-norm statistics and
AdamW moments alike, which the port's modules load with the option on or
off."""

import importlib.util
from pathlib import Path

import numpy as np
import torch

import jax

from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from vm_asr_tpu.models.discriminator import unstack_mpd_params
from vm_asr_tpu_torch.compat import flax_disc_variables_to_state_dict
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.models import (
    MultiPeriodDiscriminator,
    StackedMultiPeriodDiscriminator,
    get_discriminators,
)
from tests.test_torch_trainer import _adam_state, _tiny
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "jax_checkpoint_to_pth", ROOT / "scripts" / "jax_checkpoint_to_pth.py")
script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(script)

GROUPS = [[2], [3]]


def _stacked(c, out):
    c = _tiny(c, out)
    c.TRAIN.ADVERSARIAL.DISCRIMINATORS = ["mpd", "msd"]
    c.TRAIN.ADVERSARIAL.MPD_STACKED = True
    c.TRAIN.ADVERSARIAL.MPD_STACK_GROUPS = GROUPS
    c.TRAIN.ADVERSARIAL.MSD_HIDDEN = 16
    return c


def test_stacked_mpd_and_msd_run_converts(tmp_path):
    """The JAX states (shaped by the script's own targets, filled from a
    seeded numpy generator) saved by the JAX CheckpointManager; the script's
    files hold the JAX package's unstack_mpd_params of the MPD and the MSD
    as they are, by the port's names, and load into the stacked and the
    unstacked MPD alike."""
    jcfg = _stacked(jax_default_config(), tmp_path / "jax")
    targets = script.jax_targets(jcfg)
    assert sorted(targets) == ["G", "mpd", "msd"]
    rng = np.random.default_rng(0)

    def fill(tree):
        return jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(a.dtype)
            if np.issubdtype(a.dtype, np.floating) else np.full(a.shape, 3, a.dtype), tree)

    states = {tag: fill(s) for tag, s in targets.items()}
    ckpt = JaxCheckpointManager(str(tmp_path / "jax"))
    for tag, state in states.items():
        ckpt.save(tag, state, epoch=0, monitor_best=1.5,
                  config=jcfg.to_dict() if tag == "G" else None)
    written = script.convert_run(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert sorted(Path(p).name for p in written) == [
        f"checkpoint-latest-{t}.pth" for t in ("G", "mpd", "msd")]

    periods = tuple(jcfg.TRAIN.ADVERSARIAL.MPD_PERIODS)
    groups = tuple(tuple(g) for g in GROUPS)
    for tag in ("mpd", "msd"):
        s = states[tag]
        variables = {"params": s.params, "batch_stats": s.batch_stats}
        moments = _adam_state(s.opt_state)
        if tag == "mpd":  # the JAX package's own unstacking as the reference
            variables = unstack_mpd_params(variables, periods=periods, groups=groups)
            mu = unstack_mpd_params({"params": moments.mu}, periods=periods, groups=groups)
        else:
            mu = {"params": moments.mu}
        want = flax_disc_variables_to_state_dict(variables)
        want_mu = flax_disc_variables_to_state_dict(mu)
        blob = torch.load(tmp_path / "port" / f"checkpoint-latest-{tag}.pth", weights_only=True)
        got = blob["state_dict"]
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], v) for k, v in want.items())
        assert not any(k.startswith("group_") for k in got)
        pcfg = _stacked(default_config(), tmp_path / "unused")
        module = get_discriminators(pcfg, "cpu")[tag]
        names = {id(p): n for n, p in module.named_parameters()}
        order = [names[id(p)] for g in script.make_optimizer(pcfg, 1, module).tx.param_groups
                 for p in g["params"]]
        for i, st in blob["optimizer"]["tx"]["state"].items():
            assert torch.equal(st["exp_avg"], want_mu[order[i]]), order[i]
        if tag == "mpd":
            assert isinstance(module, StackedMultiPeriodDiscriminator)
            module.load_state_dict(got, strict=True)
            MultiPeriodDiscriminator(hidden=2, periods=periods).load_state_dict(got, strict=True)
