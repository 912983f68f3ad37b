#!/usr/bin/env python3
"""Convert a JAX run's orbax checkpoints into the PyTorch port's ``.pth`` files.

    python scripts/jax_checkpoint_to_pth.py RUN_DIR [--out DIR] [--cfg YAML --opts K V ...]

RUN_DIR is a run folder of the JAX package (``vm_asr_tpu.cli`` training
writes ``OUTPUT/MODEL.NAME/TAG``): orbax directories
``checkpoint-{latest,best,epoch-N}-{G,mpd}`` with their ``meta.json``. For
every kind found this writes ``checkpoint-{kind}-{G,mpd}.pth`` into DIR
(default RUN_DIR) in the layout of ``vm_asr_tpu_torch/core/checkpoint.py``:

- ``state_dict``: the generator's params through
  ``compat.flax_params_to_state_dict``; each discriminator's (the MPD, the
  MSD) params and spectral-norm ``u``/``sigma`` through
  ``compat.flax_disc_variables_to_state_dict``, which unstacks a run
  trained with MPD_STACKED (its ``group_g`` trees) by the port's own
  ``unstack_mpd_state``: the port's ``.pth`` files keep the unstacked
  layout with the option on or off;
- ``optimizer``: torch AdamW state with optax's moments ``mu``/``nu`` as
  ``exp_avg``/``exp_avg_sq`` and its count as ``step``, and the update
  count;
- ``step``, ``epoch`` and ``monitor_best`` from the checkpoint, and the
  generator's config.

The port's ``--eval``, ``--inference`` and ``--resume DIR`` then read DIR as
they read a run of their own. The model is built from ``config.json`` of the
run's generator checkpoint unless ``--cfg`` (and ``--opts``) are given.

Needs JAX, flax, orbax (with tensorstore) and torch on one machine; the port
itself imports none of JAX, so this script is the one bridge. Only runs
with AdamW and no gradient accumulation (as every shipped config trains)
are converted; SGD and ACCUMULATION_STEPS > 1 raise.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from vm_asr_tpu.core import load_config  # noqa: E402
from vm_asr_tpu.core.checkpoint import CheckpointManager  # noqa: E402
from vm_asr_tpu.core.config import CfgNode as JaxCfgNode  # noqa: E402
from vm_asr_tpu.models import get_model  # noqa: E402
from vm_asr_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from vm_asr_tpu.train.states import DiscState as JaxDiscState  # noqa: E402
from vm_asr_tpu.train.states import GenState as JaxGenState  # noqa: E402
from vm_asr_tpu_torch.compat import (  # noqa: E402
    flax_disc_variables_to_state_dict,
    flax_params_to_state_dict,
)
from vm_asr_tpu_torch.core.config import CfgNode  # noqa: E402
from vm_asr_tpu_torch.models import get_discriminators, get_generator  # noqa: E402
from vm_asr_tpu_torch.train import DiscState, GenState, make_optimizer  # noqa: E402


def run_kinds(run_dir: str) -> List[str]:
    """The checkpoint kinds in ``run_dir`` (latest, best, epoch-N) that hold
    an orbax generator directory."""
    kinds = []
    for path in sorted(glob.glob(os.path.join(run_dir, "checkpoint-*-G"))):
        if os.path.isdir(path):
            kinds.append(re.fullmatch(r"checkpoint-(.+)-G", os.path.basename(path)).group(1))
    return kinds


def run_config(run_dir: str, kinds: List[str], cfg: Optional[str], opts) -> dict:
    """The run's config as a plain dict: from ``--cfg``/``--opts``, else from
    the generator checkpoint's config.json."""
    if cfg:
        return load_config(cfg, opts).to_dict()
    for kind in kinds:
        path = os.path.join(run_dir, f"checkpoint-{kind}-G", "config.json")
        if os.path.isfile(path):
            with open(path) as f:
                return json.load(f)
    raise FileNotFoundError(f"no config.json under {run_dir}; pass --cfg (and --opts)")


def jax_targets(config) -> Dict[str, object]:
    """Zero-filled JAX train states shaped as the run's, to restore into:
    {"G": GenState, name: DiscState}."""
    if config.TRAIN.OPTIMIZER.NAME.lower() != "adamw" or config.TRAIN.ACCUMULATION_STEPS > 1:
        raise NotImplementedError(
            f"optimizer {config.TRAIN.OPTIMIZER.NAME}, ACCUMULATION_STEPS "
            f"{config.TRAIN.ACCUMULATION_STEPS}: only AdamW without accumulation is converted")
    models = get_model(config)
    seg = int(config.DATA.SEGMENT * config.DATA.TARGET_SR)
    x = jnp.zeros((1, 1, seg), jnp.float32)
    rng = jax.random.PRNGKey(0)

    def zeros(tree):
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)

    gen_vars = zeros(jax.eval_shape(models["generator"].init, {"params": rng, "dropout": rng},
                                    x, jnp.zeros((1,), jnp.int32)))
    out = {"G": JaxGenState.create(gen_vars["params"], jax_make_optimizer(config, 1))}
    for name, disc in sorted(models.items()):
        if name == "generator":
            continue
        dvars = zeros(jax.eval_shape(disc.init, rng, x, x))
        out[name] = JaxDiscState.create(dvars, jax_make_optimizer(config, 1))
    return out


def _adam_state(opt_state):
    """optax.adamw's ScaleByAdamState (count, mu, nu) in its state tree."""
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda n: hasattr(n, "mu"))
    return next(n for n in leaves if hasattr(n, "mu"))


def port_blob(tag: str, restored: dict, module: torch.nn.Module, port_config,
              config_dict: Optional[dict]) -> dict:
    """The port's checkpoint dict for one restored JAX state."""
    state = jax.tree_util.tree_map(np.asarray, restored["state"])
    if tag == "G":
        def convert(tree):
            return flax_params_to_state_dict(tree)
        weights = convert(state.params)
        wrap = GenState
    else:
        adv = port_config.TRAIN.ADVERSARIAL  # the MPD's periods and groups, if stacked
        stacking = dict(periods=tuple(adv.MPD_PERIODS), groups=adv.MPD_STACK_GROUPS or None)

        def convert(tree):
            return flax_disc_variables_to_state_dict({"params": tree}, **stacking)
        weights = flax_disc_variables_to_state_dict(
            {"params": state.params, "batch_stats": state.batch_stats}, **stacking)
        wrap = DiscState
    module.load_state_dict(weights, strict=True)
    optimizer = make_optimizer(port_config, 1, module)
    adam = _adam_state(state.opt_state)
    mu, nu = convert(adam.mu), convert(adam.nu)
    names = {id(p): n for n, p in module.named_parameters()}
    count = int(adam.count)
    for p in optimizer.params:
        n = names[id(p)]
        optimizer.tx.state[p] = {"step": torch.tensor(float(count)),
                                 "exp_avg": mu[n].clone(), "exp_avg_sq": nu[n].clone()}
    optimizer.count = count
    blob = wrap(module, optimizer, int(state.step)).state_dict()
    return dict(blob, epoch=int(restored["epoch"]), monitor_best=float(restored["monitor_best"]),
                config=config_dict if tag == "G" else None)


def convert_run(run_dir: str, out_dir: Optional[str] = None, cfg: Optional[str] = None,
                opts=None) -> List[str]:
    """Write the port's ``.pth`` files for every checkpoint of ``run_dir``;
    returns their paths."""
    run_dir = os.path.abspath(run_dir)
    out_dir = os.path.abspath(out_dir or run_dir)
    kinds = run_kinds(run_dir)
    if not kinds:
        raise FileNotFoundError(f"no orbax checkpoint-*-G directory in {run_dir}")
    config_dict = run_config(run_dir, kinds, cfg, opts)
    targets = jax_targets(JaxCfgNode(config_dict))
    port_config = CfgNode(config_dict)
    modules = {"G": get_generator(port_config, "cpu"),
               **get_discriminators(port_config, "cpu")}
    if set(modules) != set(targets):
        raise ValueError(f"port models {sorted(modules)} against JAX states {sorted(targets)}")
    ckpt = CheckpointManager(run_dir)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for kind in kinds:
        for tag, target in targets.items():
            restored = ckpt.restore(tag, kind, target=target)
            if restored is None:
                continue
            blob = port_blob(tag, restored, modules[tag], port_config, config_dict)
            dst = os.path.join(out_dir, f"checkpoint-{kind}-{tag}.pth")
            tmp = f"{dst}.tmp{os.getpid()}"
            torch.save(blob, tmp)
            os.replace(tmp, dst)
            written.append(dst)
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run_dir", help="the JAX run folder with checkpoint-*-G/ directories")
    p.add_argument("--out", default=None, help="where to write the .pth files (default RUN_DIR)")
    p.add_argument("--cfg", default=None, help="config yaml (default: the run's config.json)")
    p.add_argument("--opts", nargs="+", default=None, help="KEY VALUE overrides with --cfg")
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    for path in convert_run(args.run_dir, args.out, args.cfg, args.opts):
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
