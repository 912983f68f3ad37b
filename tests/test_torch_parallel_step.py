"""The port's data-parallel train step (two gloo ranks on the CPU) against
its one-process step at the same global batch and against the JAX step on
a dp=2 mesh (vm_asr_tpu.parallel.make_mesh over two virtual CPU devices).

Cases (tests/torch_parallel.py:STEP_CASES), a global batch of 4 whose rows
sit at levels a decade apart, so that the ranks' spectral norms differ:
- "mpd": the multi-resolution STFT loss (its spectral convergence is a
  ratio of norms over the whole batch) and the MPD, against the one-process
  step and the JAX step;
- "msd_wgan": the MPD beside the MSD under wgan-gp, against the
  one-process step: the interpolation weights are the port's own draws, for
  the global batch, each rank its rows. (No JAX step of the MSD is run: the
  JAX MSD's grouped convs are 204 dense convs whatever its width, and XLA
  takes minutes to compile its step on the CPU, PERF.md §7. The one-process
  port step with the MSD is held to the JAX step by
  tests/test_torch_gan_options.py.)
- "mpd_wgan": the MPD under wgan-gp, against the one-process step and the
  JAX step, with the JAX step's interpolation weights for the global batch
  (each rank takes its rows of them): the penalty's double backward and the
  wgan-gp metrics under dp;
- "mpd_droppath": "mpd" with DropPath on, against the one-process step (the
  two frameworks draw other bits): the masks drawn for the global batch.
For the JAX cases the generator is a seeded port init carried to flax and
the MPD a JAX init carried to the port (tests/test_torch_gan_options.py's
way); the other cases take the port's seeded inits. The JAX step's
gradients are read from AdamW's first moment after its first step,
(1 − β1)·g, for every leaf of every model. All the cases run on one pair
of ranks, started once for the module.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu.compat.torch_port import state_dict_to_flax
from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.models import get_model
from vm_asr_tpu.parallel import make_mesh as jax_make_mesh
from vm_asr_tpu.parallel import replicate_tree as jax_replicate_tree
from vm_asr_tpu.parallel import shard_batch as jax_shard_batch
from vm_asr_tpu.train.optim import make_optimizer as jax_make_optimizer
from vm_asr_tpu.train.states import DiscState as JaxDiscState
from vm_asr_tpu.train.states import GenState as JaxGenState
from vm_asr_tpu.train.steps import make_train_step as jax_make_train_step
from vm_asr_tpu_torch.compat import flax_disc_variables_to_state_dict, flax_params_to_state_dict
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.models import get_discriminators, get_generator
from tests import torch_parallel as tp
from tests.torch_threads import one_torch_thread  # noqa: F401

JAX_CASES = ("mpd", "mpd_wgan")
# Two ranks against one process: the same fp32 maths, the batch's sums split
# over two ranks (and the STFTs and convolutions of 2 rows rather than 4) and
# averaged. Observed: metrics up to 6e-6 of their scale (lsd_lf), gradients
# up to 3.8e-5 of their tensor's largest element where that is above 1e-6 of
# the model's largest (smaller ones cancel to rounding). Metrics 5e-5 of
# their scale (_scale); each gradient 1e-4 of its tensor's largest element
# plus 1e-7 of the model's largest. A lost rank, a sum for a mean or a
# per-rank spectral convergence moves them by O(1).
DP_REL, DP_GRAD_REL, DP_GRAD_FLOOR = 5e-5, 1e-4, 1e-7
# Against the JAX step: the bars of tests/test_torch_train_step.py (metrics
# 1e-4; gradients 1e-3 of each tensor's largest + 1e-9 of the model's
# largest; spectral-norm statistics 1e-5; AdamW's first update as
# _updates_close says).
METRIC_REL, GRAD_REL, GRAD_FLOOR, STATS_REL = 1e-4, 1e-3, 1e-9, 1e-5
LR = 1e-3
JAX_RNG = jax.random.PRNGKey(5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scale(log, key):
    """What a metric is held relative to: itself, but ``disc_gap/<name>``
    and ``disc_gap/<name>_max``, differences of scores that cancel, relative
    to the scores' size (tests/test_torch_jax_checkpoint.py's rule):
    √|discriminator loss|."""
    name = key.partition("/")[2].removesuffix("_max")
    if key.startswith("disc_gap/"):
        return max(abs(log[key]), math.sqrt(abs(log[f"discriminator/{name}"])))
    return abs(log[key])


def _grads_close(got, ref, rel, floor):
    top = max(float(v.abs().max()) for v in ref.values())
    assert set(got) == set(ref)
    for name, r in ref.items():
        err = float((got[name] - r).abs().max())
        assert err <= rel * float(r.abs().max()) + floor * top, (name, err)


def _updates_close(got, ref, keys):
    """AdamW's first update is lr·g/(|g| + eps) ≈ ±lr per element: an element
    whose gradient is fp32 noise may step apart by up to 2·lr; only a few
    may differ at all (tests/test_torch_gan_options.py's rule)."""
    diff = np.concatenate([(got[k] - ref[k]).abs().numpy().ravel() for k in keys]) / LR
    assert diff.max() <= 2.0 + 1e-3 and (diff > 0.01).mean() <= 1e-3, \
        (diff.max(), (diff > 0.01).mean())


def _spec(case):
    """Weights and batch of ``case``, with the JAX discriminators'
    variables for the JAX step, and under wgan-gp the JAX step's
    interpolation weights (``alphas``, one per discriminator in name
    order)."""
    pcfg = tp.step_config(default_config(), case)
    gen = get_generator(pcfg, "cpu")
    batch = tp.step_batch()
    spec = dict(gen=gen.state_dict(), batch=batch)
    discs = get_discriminators(pcfg, "cpu")
    if case not in JAX_CASES:
        spec["discs"] = {n: d.state_dict() for n, d in discs.items()}
        return spec, None
    jcfg = tp.step_config(jax_default_config(), case)
    jmodels = get_model(jcfg)
    y = jnp.asarray(batch["wave_target"][:2])
    jvars = {n: _np(jax.jit(jmodels[n].init)(jax.random.PRNGKey(1 + i), y, y))
             for i, n in enumerate(sorted(discs))}
    spec["discs"] = {n: flax_disc_variables_to_state_dict(v) for n, v in jvars.items()}
    if jcfg.TRAIN.ADVERSARIAL.GAN_LOSS_TYPE == "wgan-gp":
        spec["alphas"] = [np.asarray(jax.random.uniform(jax.random.fold_in(JAX_RNG, di),
                                                        (tp.GLOBAL_BATCH, 1, 1)))
                          for di in range(len(jvars))]
    return spec, jvars


def _gradients(state, b1):
    """A JAX state's gradient of its first step: AdamW's first moment over
    (1 − β1)."""
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    return jax.tree_util.tree_map(lambda m: np.asarray(m, np.float64) / (1.0 - b1), adam.mu)


def _jax_dp2_step(case, spec, jvars):
    """The JAX step on a dp=2 mesh from the same state and batch: metrics,
    every model's gradients and the states after the step."""
    cfg = tp.step_config(jax_default_config(), case)
    models = get_model(cfg)
    mesh = jax_make_mesh(dp=2, devices=jax.devices()[:2])
    opt = lambda: jax_make_optimizer(cfg, tp.STEPS_PER_EPOCH)  # noqa: E731
    params = state_dict_to_flax({k: v.numpy() for k, v in spec["gen"].items()})
    gs = jax_replicate_tree(JaxGenState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                               opt()), mesh)
    ds = {n: jax_replicate_tree(JaxDiscState.create(jax.tree_util.tree_map(jnp.asarray, v), opt()),
                                mesh) for n, v in jvars.items()}
    batch = jax_shard_batch({k: jnp.asarray(v.astype(np.int32) if k == "highcut" else v)
                             for k, v in spec["batch"].items()}, mesh)
    step = jax_make_train_step(cfg, models["generator"], {n: models[n] for n in jvars})
    gs2, ds2, metrics = step(gs, ds, batch, JAX_RNG)
    b1 = cfg.TRAIN.OPTIMIZER.BETAS[0]
    grads = {"generator": flax_params_to_state_dict(_gradients(gs2, b1)),
             **{n: flax_disc_variables_to_state_dict({"params": _gradients(ds2[n], b1)})
                for n in jvars}}
    return dict(metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
                gen=flax_params_to_state_dict(_np(gs2.params)),
                discs={n: flax_disc_variables_to_state_dict(
                    {"params": _np(ds2[n].params), "batch_stats": _np(ds2[n].batch_stats)})
                    for n in jvars})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the two ranks' results, the one-process step's, and (for
    the JAX cases) the JAX dp=2 step's."""
    tmp = tmp_path_factory.mktemp("parallel_step")
    specs, jvars = {}, {}
    for case in tp.STEP_CASES:
        specs[case], jvars[case] = _spec(case)
        torch.save(specs[case], tp.spec_path(tmp, f"step:{case}"))
    torch.save(specs["mpd"], tp.spec_path(tmp, "step_mp:mpd"))
    ranks = tp.launch([f"step:{c}" for c in tp.STEP_CASES] + ["step_mp:mpd"], tmp)
    out = {case: dict(ranks=ranks[f"step:{case}"], one=tp.run_step(case, specs[case]),
                      jax=_jax_dp2_step(case, specs[case], jvars[case])
                      if case in JAX_CASES else None)
           for case in tp.STEP_CASES}
    out["mp"] = ranks["step_mp:mpd"]
    return out


@pytest.mark.parametrize("case", sorted(tp.STEP_CASES))
def test_ranks_agree(runs, case):
    """Both ranks report the same metrics and hold bitwise the same
    gradients and states after the step: every rank took the same step."""
    r0, r1 = runs[case]["ranks"]
    assert r0["metrics"] == r1["metrics"]
    for name in r0["grads"]:
        for k, g in r0["grads"][name].items():
            assert torch.equal(g, r1["grads"][name][k]), (name, k)
        for k, v in r0["state"][name].items():
            assert torch.equal(v, r1["state"][name][k]), (name, k)


@pytest.mark.parametrize("case", sorted(tp.STEP_CASES))
def test_dp2_step_matches_one_process(runs, case):
    """Losses, metrics and every gradient leaf of every model against the
    step one process takes on the whole batch."""
    got, ref = runs[case]["ranks"][0], runs[case]["one"]
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, r in ref["metrics"].items():
        assert abs(got["metrics"][k] - r) <= DP_REL * _scale(ref["metrics"], k), \
            (k, got["metrics"][k], r)
    assert set(got["grads"]) == set(ref["grads"]) == set(got["state"])
    for name in ref["grads"]:
        _grads_close(got["grads"][name], ref["grads"][name], DP_GRAD_REL, DP_GRAD_FLOOR)
    if case != "mpd_droppath":  # (DropPath may drop a block for every row)
        # Every generator parameter gets a gradient (a dropped one would be 0).
        assert all(float(g.abs().max()) > 0 for g in got["grads"]["generator"].values())


@pytest.mark.parametrize("case", JAX_CASES)
def test_dp2_step_matches_jax(runs, case):
    """Metrics, every gradient leaf of every model, and the states after
    the step against the JAX step on a dp=2 mesh."""
    got, ref = runs[case]["ranks"][0], runs[case]["jax"]
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, r in ref["metrics"].items():
        assert abs(got["metrics"][k] - r) <= METRIC_REL * _scale(ref["metrics"], k), \
            (k, got["metrics"][k], r)
    assert set(got["grads"]) == set(ref["grads"])
    for name, want in ref["grads"].items():
        _grads_close(got["grads"][name], {k: torch.from_numpy(np.asarray(v, np.float32))
                                          for k, v in want.items()}, GRAD_REL, GRAD_FLOOR)
    gen = got["state"]["generator"]
    assert sorted(gen) == sorted(ref["gen"])
    _updates_close(gen, ref["gen"], ref["gen"])
    for name, want in ref["discs"].items():
        sd = got["state"][name]
        assert sorted(sd) == sorted(want)
        stats = [k for k in want if k.endswith((".u", ".sigma"))]
        for k in stats:
            err = float((sd[k] - want[k]).abs().max())
            assert err <= STATS_REL * float(want[k].abs().max()), (name, k, err)
        _updates_close(sd, want, [k for k in want if k not in stats])


def test_mp2_step_matches_one_process(runs):
    """The "mpd" step with every SS2D's directions split over the two ranks
    (dp 1 × mp 2): both ranks take the one process's step (its gradients
    averaged over the mp group too, so the replicas stay alike)."""
    r0, r1 = runs["mp"]
    ref = runs["mpd"]["one"]
    assert r0["metrics"] == r1["metrics"]
    for name in ref["grads"]:
        for k, g in r0["grads"][name].items():
            assert torch.equal(g, r1["grads"][name][k]), (name, k)
        _grads_close(r0["grads"][name], ref["grads"][name], DP_GRAD_REL, DP_GRAD_FLOOR)
    for k, r in ref["metrics"].items():
        assert abs(r0["metrics"][k] - r) <= DP_REL * _scale(ref["metrics"], k), k
