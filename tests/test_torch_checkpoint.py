"""The port's checkpoints (core/checkpoint.py, the optimizer's and the train
states' state_dict) on the CPU: the lifecycle of tests/test_checkpoint.py,
an exact resume, and a port checkpoint read by the JAX package.

The files are torch files in the reference layout
``checkpoint-{latest,best,epoch-N}-{G|mpd}.pth``, so the JAX package's
``compat.torch_port.load_torch_checkpoint`` reads the generator's weights,
and its forward on them matches the port's forward.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu.compat.torch_port import load_torch_checkpoint
from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.models import get_model
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.core.checkpoint import CheckpointManager
from vm_asr_tpu_torch.models import get_discriminators, get_generator
from vm_asr_tpu_torch.train import DiscState, GenState, make_optimizer
from tests.torch_threads import one_torch_thread  # noqa: F401

# fp32 forward, port against JAX on the same weights: both compute the same
# float32 maths in other orders (~4e-6 of the output scale observed in
# tests/test_torch_model.py); a weight that was not carried over moves the
# output by O(1).
FWD_REL = 1e-5
T = 31 * 16  # n_fft 64, hop 16: a 32×32 image


def _tiny(c, accumulation=1):
    c.MODEL.NAME = "DualStreamInteractiveMambaUNet"
    c.MODEL.VSSM.DIMS = 16
    c.MODEL.VSSM.DEPTHS = [1, 1, 1, 1]
    c.DATA.STFT.N_FFT = 64
    c.DATA.STFT.HOP_LENGTH = 16
    c.DATA.STFT.WIN_LENGTH = 64
    c.DATA.SEGMENT = T / c.DATA.TARGET_SR
    c.TRAIN.EPOCHS = 2
    c.TRAIN.WARMUP_EPOCHS = 1
    c.TRAIN.WEIGHT_DECAY = 0.05
    c.TRAIN.ACCUMULATION_STEPS = accumulation
    c.TRAIN.ADVERSARIAL.ENABLE = True
    c.TRAIN.ADVERSARIAL.DISCRIMINATORS = ["mpd"]
    c.TRAIN.ADVERSARIAL.MPD_HIDDEN = 2
    c.TRAIN.ADVERSARIAL.MPD_PERIODS = [2, 3]
    c.DTYPE.COMPUTE = "float32"
    c.AMP_ENABLE = False
    return c


def _states(cfg, seed):
    gen = get_generator(cfg, "cpu", seed=seed)
    mpd = get_discriminators(cfg, "cpu", seed=seed + 1)["mpd"]
    return (GenState(gen, make_optimizer(cfg, 4, gen)),
            DiscState(mpd, make_optimizer(cfg, 4, mpd)))


def _grads(state, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(p.shape, generator=g) * 1e-2 for p in state.params]


def _assert_states_equal(a, b):
    assert (a.step, a.optimizer.count, a.optimizer.mini_step) == \
        (b.step, b.optimizer.count, b.optimizer.mini_step)
    for (name, x), y in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        assert torch.equal(x, y), name
    sa, sb = a.optimizer.tx.state_dict(), b.optimizer.tx.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb["state"][i][k])), (i, k)
    if a.optimizer.acc is None:
        assert b.optimizer.acc is None
    else:
        assert all(torch.equal(x, y) for x, y in zip(a.optimizer.acc, b.optimizer.acc))


def test_latest_best_epoch_lifecycle(tmp_path):
    cfg = _tiny(default_config())
    gen_state, _ = _states(cfg, 0)
    ckpt = CheckpointManager(str(tmp_path))
    w = gen_state.module.state_dict()["patch_embed_mag.0.weight"]
    for epoch, best, copy in ((0, True, False), (1, False, False), (2, True, True)):
        w.fill_(float(epoch))
        ckpt.save("G", gen_state, epoch=epoch, monitor_best=1.0 / (epoch + 1),
                  config=cfg.to_dict() if epoch == 0 else None, best=best, epoch_copy=copy)
    assert ckpt.has("G", "latest") and ckpt.has("G", "best") and ckpt.has("G", "epoch-2")
    assert not ckpt.has("G", "epoch-0") and not ckpt.has("mpd")
    latest = ckpt.load("G", "latest")
    assert set(latest) == {"state_dict", "optimizer", "step", "epoch", "monitor_best", "config"}
    assert latest["epoch"] == 2 and latest["monitor_best"] == pytest.approx(1 / 3)
    assert torch.equal(latest["state_dict"]["patch_embed_mag.0.weight"], w)
    assert ckpt.restore("G", "best")["monitor_best"] == pytest.approx(1 / 3)
    assert ckpt.restore("G", "latest", target=gen_state)["state"] is gen_state
    assert not list(tmp_path.glob("*.tmp*")), "a temporary file was left behind"


def test_restore_missing_returns_none(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.restore("G", "latest") is None
    assert ckpt.load("mpd") is None
    assert CheckpointManager.find_best(str(tmp_path)) is None


def test_find_best_and_weights_only(tmp_path):
    cfg = _tiny(default_config())
    gen_state, _ = _states(cfg, 0)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("G", gen_state, 0, 0.5, cfg.to_dict(), best=True)
    path = CheckpointManager.find_best(str(tmp_path), "G")
    assert path.endswith("checkpoint-best-G.pth")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    assert isinstance(blob["config"], dict) and blob["config"]["MODEL"]["VSSM"]["DIMS"] == 16


@pytest.mark.parametrize("accumulation", [1, 2])
def test_resume_restores_exactly(tmp_path, accumulation):
    """Weights, AdamW moments, the schedule's count, the accumulation buffer
    and the step of the generator and the MPD come back bit for bit, and the
    next update is the same."""
    cfg = _tiny(default_config(), accumulation)
    gen_state, disc_state = _states(cfg, 0)
    for i in range(3):
        gen_state.apply_gradients(_grads(gen_state, i))
        disc_state.apply_gradients(_grads(disc_state, 10 + i))
    assert gen_state.optimizer.count == (3 if accumulation == 1 else 1)
    assert (gen_state.optimizer.acc is not None) == (accumulation == 2)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("G", gen_state, 4, 0.25, cfg.to_dict())
    ckpt.save("mpd", disc_state, 4, 0.25)

    gen2, disc2 = _states(cfg, 7)  # other weights, fresh optimizers
    r = ckpt.restore("G", "latest", target=gen2)
    assert (r["epoch"], r["monitor_best"]) == (4, 0.25)
    ckpt.restore("mpd", "latest", target=disc2)
    _assert_states_equal(gen_state, gen2)
    _assert_states_equal(disc_state, disc2)
    for a, b in ((gen_state, gen2), (disc_state, disc2)):
        a.apply_gradients(_grads(a, 99))
        b.apply_gradients(_grads(b, 99))
        _assert_states_equal(a, b)


def test_jax_package_reads_a_port_checkpoint(tmp_path):
    """compat.torch_port.load_torch_checkpoint reads the port's
    checkpoint-best-G.pth, and the JAX forward on those params matches the
    port's forward (fp32)."""
    cfg = _tiny(default_config())
    gen_state, _ = _states(cfg, 3)
    gen_state.apply_gradients(_grads(gen_state, 0))
    CheckpointManager(str(tmp_path)).save("G", gen_state, 0, 1.0, cfg.to_dict(), best=True)
    params = load_torch_checkpoint(str(tmp_path / "checkpoint-best-G.pth"))

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 1, T))
    x = x + (np.abs(x).max() + 1.0) * (-1.0) ** np.arange(T)  # see test_torch_model._wave
    x[..., :64] = 0.0
    x[..., -64:] = 0.0
    x = (0.1 * x).astype(np.float32)
    hf = np.array([8, 20], np.int32)
    jgen = get_model(_tiny(jax_default_config()))["generator"]
    ref = np.asarray(jgen.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                jnp.asarray(x), jnp.asarray(hf), deterministic=True))
    gen_state.module.eval()
    with torch.no_grad():
        got = gen_state.module(torch.from_numpy(x), torch.from_numpy(hf).long()).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < FWD_REL
