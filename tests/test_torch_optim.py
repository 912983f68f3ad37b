"""The port's optimizer and schedules (vm_asr_tpu_torch.train.optim) against
vm_asr_tpu.train.optim (optax), on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.models import VSSBlock as JaxVSSBlock
from vm_asr_tpu.train import optim as jax_optim
from vm_asr_tpu_torch.compat import flax_params_to_state_dict
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.models import VSSBlock
from vm_asr_tpu_torch.train import make_optimizer, make_schedule
from vm_asr_tpu_torch.train.optim import decays

# optax evaluates schedules in float32, the port in float64: rounding at the
# scale of the largest term, BASE_LR (the warm-up's (MIN_LR - BASE_LR)·frac +
# BASE_LR cancels to MIN_LR with an error of ~1e-10).
SCHED_ATOL = 1e-6 * 1e-3
# Two fp32 updates of O(1) parameters, lr ~1e-3: rounding of the update.
PARAM_TOL = dict(rtol=1e-6, atol=1e-7)
STEPS_PER_EPOCH = 5


def _config(c, scheduler="cosine", optimizer="adamw", wd=0.0, accumulation=1):
    c.TRAIN.EPOCHS = 10
    c.TRAIN.WARMUP_EPOCHS = 2
    c.TRAIN.BASE_LR = 1e-3
    c.TRAIN.MIN_LR = 1e-5
    c.TRAIN.WEIGHT_DECAY = wd
    c.TRAIN.ACCUMULATION_STEPS = accumulation
    c.TRAIN.LR_SCHEDULER.NAME = scheduler
    c.TRAIN.LR_SCHEDULER.MULTISTEPS = [3, 6]
    c.TRAIN.LR_SCHEDULER.GAMMA = 0.1
    c.TRAIN.LR_SCHEDULER.DECAY_EPOCHS = 3
    c.TRAIN.LR_SCHEDULER.DECAY_RATE = 0.5
    c.TRAIN.OPTIMIZER.NAME = optimizer
    return c


@pytest.mark.parametrize("name", ["cosine", "linear", "multistep", "step"])
def test_schedule_matches_optax(name):
    """Steps 0 and 1, the end of warm-up (10), the boundaries around it and
    the multistep/step thresholds (15, 16, 30), and the last step (49)."""
    ref = jax_optim.make_schedule(_config(jax_default_config(), name), STEPS_PER_EPOCH)
    got = make_schedule(_config(default_config(), name), STEPS_PER_EPOCH)
    for n in (0, 1, 9, 10, 11, 15, 16, 25, 30, 49, 60):
        r = float(ref(n))
        assert abs(got(n) - r) <= SCHED_ATOL, (name, n, got(n), r)
    assert got(0) == pytest.approx(1e-5 if name != "step" else 1e-3)


class _Tiny(torch.nn.Module):
    """fc (Linear: weight decays, bias does not), A_logs (2-D, excluded by
    name), scale (1-D)."""

    def __init__(self, w, b, a, s):
        super().__init__()
        self.fc = torch.nn.Linear(3, 4)
        with torch.no_grad():
            self.fc.weight.copy_(torch.from_numpy(w.T))
            self.fc.bias.copy_(torch.from_numpy(b))
        self.A_logs = torch.nn.Parameter(torch.from_numpy(a.copy()))
        self.scale = torch.nn.Parameter(torch.from_numpy(s.copy()))


def _tiny_params(rng):
    return dict(
        fc=dict(kernel=rng.standard_normal((3, 4)).astype(np.float32),
                bias=rng.standard_normal(4).astype(np.float32)),
        A_logs=rng.standard_normal((4, 1)).astype(np.float32),
        scale=rng.standard_normal(4).astype(np.float32),
    )


def _to_port(tree):
    return {"fc.weight": tree["fc"]["kernel"].T, "fc.bias": tree["fc"]["bias"],
            "A_logs": tree["A_logs"], "scale": tree["scale"]}


@pytest.mark.parametrize("optimizer,wd,accumulation", [
    ("adamw", 0.0, 1), ("adamw", 0.05, 1), ("sgd", 0.05, 1), ("adamw", 0.05, 2)])
def test_updates_match_optax(optimizer, wd, accumulation):
    """Updates on the same gradients against optax: AdamW without and with
    the decay mask, nesterov SGD, and MultiSteps accumulation (4 calls, 2
    updates with k = 2). The schedule starts in warm-up at MIN_LR."""
    rng = np.random.default_rng(0)
    params = _tiny_params(rng)
    grads = [_tiny_params(rng) for _ in range(4 if accumulation > 1 else 2)]
    tx = jax_optim.make_optimizer(
        _config(jax_default_config(), optimizer=optimizer, wd=wd, accumulation=accumulation),
        STEPS_PER_EPOCH)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, updates)

    cfg = _config(default_config(), optimizer=optimizer, wd=wd, accumulation=accumulation)
    module = _Tiny(params["fc"]["kernel"], params["fc"]["bias"], params["A_logs"],
                   params["scale"])
    opt = make_optimizer(cfg, STEPS_PER_EPOCH, module)
    names = [n for n, _ in module.named_parameters()]
    applied = [opt.apply(torch.from_numpy(np.ascontiguousarray(_to_port(g)[n])) for n in names)
               for g in grads]
    assert applied == ([False, True] * 2 if accumulation > 1 else [True, True])
    assert opt.count == 2
    got = dict(module.named_parameters())
    for n, r in _to_port(jax.tree_util.tree_map(np.asarray, p)).items():
        np.testing.assert_allclose(got[n].detach().numpy(), r, err_msg=n, **PARAM_TOL)


def test_decay_mask_matches_jax():
    """The no-decay rule over a VSSBlock's parameters (LayerNorm scales and
    biases, MLP biases, A_logs, Ds, dt_projs_bias out; kernels and the
    stacked projections in)."""
    x = jnp.zeros((1, 4, 4, 16))
    params = JaxVSSBlock(hidden_dim=16, scan_impl="ref").init(jax.random.PRNGKey(0), x)["params"]
    mask = flax_params_to_state_dict(jax.tree_util.tree_map(
        lambda m, leaf: np.full(leaf.shape, m, np.float32), jax_optim.no_decay_mask(params),
        params))
    block = VSSBlock(16)
    got = {n: decays(n, p) for n, p in block.named_parameters()}
    assert set(got) == set(mask)
    assert got == {n: bool(m.reshape(-1)[0]) for n, m in mask.items()}
    assert any(got.values()) and not all(got.values())
