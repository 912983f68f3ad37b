#!/usr/bin/env python
"""Seconds the JAX package's GAN train step takes to trace, compile and run
once on a dp=2 mesh of virtual CPU devices, at the tiny config of the
port's data-parallel step tests (tests/torch_parallel.py:step_config):

    python scripts/jax_step_compile_time.py --discriminators mpd,msd --gan wgan-gp
    python scripts/jax_step_compile_time.py --discriminators mpd --periods 2,3 --gan wgan-gp
    python scripts/jax_step_compile_time.py --discriminators msd --msd_hidden 16 --gan lsgan

It tells which JAX steps those CPU tests can afford to compile. Prints one
JSON line: the options and the seconds of the first call (XLA's compile
dominates it). The persistent compile cache stays off, so a run is cold.
"""

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=2").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--discriminators", default="mpd,msd")
    p.add_argument("--periods", default="2,3", help="MPD_PERIODS")
    p.add_argument("--msd_hidden", type=int, default=16)
    p.add_argument("--dims", type=int, default=8)
    p.add_argument("--gan", default="wgan-gp", help="GAN_LOSS_TYPE")
    a = p.parse_args()

    from tests import torch_parallel as tp
    from vm_asr_tpu.core import default_config
    from vm_asr_tpu.models import get_model
    from vm_asr_tpu.parallel import make_mesh, replicate_tree, shard_batch
    from vm_asr_tpu.train.optim import make_optimizer
    from vm_asr_tpu.train.states import DiscState, GenState
    from vm_asr_tpu.train.steps import make_train_step

    cfg = tp.step_config(default_config(), "msd_wgan")
    adv = cfg.TRAIN.ADVERSARIAL
    adv.DISCRIMINATORS = a.discriminators.split(",")
    adv.MPD_PERIODS = [int(v) for v in a.periods.split(",")]
    adv.MSD_HIDDEN = a.msd_hidden
    adv.GAN_LOSS_TYPE = a.gan
    cfg.MODEL.VSSM.DIMS = a.dims
    models = get_model(cfg)
    b = {k: jnp.asarray(v.astype(np.int32) if k == "highcut" else v)
         for k, v in tp.step_batch().items()}
    gen_vars = jax.jit(lambda k: models["generator"].init(k, b["wave_input"], b["highcut"]))(
        jax.random.PRNGKey(0))
    disc_vars = {n: jax.jit(models[n].init)(jax.random.PRNGKey(1), b["wave_target"],
                                            b["wave_target"]) for n in adv.DISCRIMINATORS}
    mesh = make_mesh(dp=2, devices=jax.devices()[:2])
    gs = replicate_tree(GenState.create(gen_vars["params"], make_optimizer(cfg, 10)), mesh)
    ds = {n: replicate_tree(DiscState.create(v, make_optimizer(cfg, 10)), mesh)
          for n, v in disc_vars.items()}
    step = make_train_step(cfg, models["generator"], {n: models[n] for n in disc_vars})
    t0 = time.perf_counter()
    jax.block_until_ready(step(gs, ds, shard_batch(b, mesh), jax.random.PRNGKey(5)))
    print(json.dumps(dict(vars(a), first_call_s=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
