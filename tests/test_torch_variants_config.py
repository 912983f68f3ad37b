"""The port's generator factory against the JAX package's, on the CPU: every
MODEL.VSSM option the JAX factory passes is read, and set to a non-default
value it is honoured (the port builds the JAX model's parameters and the
option's behaviour) or refused, never dropped; every shipped config builds
through the CLI's config path; and each variant's checkpoint, as the port's
own save writes it, loads back by name."""

import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.models import factory as jax_factory
from vm_asr_tpu.models import get_model
from vm_asr_tpu_torch import cli
from vm_asr_tpu_torch.compat import flax_params_to_state_dict, load_reference_checkpoint
from vm_asr_tpu_torch.core import default_config, get_config
from vm_asr_tpu_torch.core.checkpoint import CheckpointManager
from vm_asr_tpu_torch.models import (
    SS2D,
    DropPath,
    DualStreamInteractiveMambaUNet,
    GMlp,
    MambaUNet,
    Mlp,
    VSSBlock,
    generator_kwargs,
    get_generator,
    to_stacked,
)
from vm_asr_tpu_torch.train import GenState, make_optimizer
from tests.torch_native import jax_uses_port_native  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# n_fft 128, hop 32, 2016 samples: a 64×64 image, deep enough for the
# latent layout's five stages.
T = 63 * 32


def _tiny(c, name="DualStreamInteractiveMambaUNet"):
    c.MODEL.NAME = name
    c.MODEL.VSSM.DEPTHS = [1, 1, 1, 1]
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = T / 16000
    c.DATA.STFT.N_FFT = 128
    c.DATA.STFT.HOP_LENGTH = 32
    c.DATA.STFT.WIN_LENGTH = 128
    c.AMP_ENABLE = False
    return c


def _of(model, cls):
    return [m for m in model.modules() if isinstance(m, cls)]


# Each MODEL.VSSM option the JAX factory passes (and MODEL.NAME), set away
# from its default: (config overrides, check of the port's model or None).
# Every case also holds the port's parameters, names and shapes to the JAX
# model's (tests/test_torch_variants_{model,layout}.py hold the outputs).
OPTIONS = {
    "IN_CHANS": ({"IN_CHANS": 2}, lambda m: m.output_layer_mag[5].blocks[0].op.d_inner == 4),
    "DEPTHS": ({"DEPTHS": [1, 2, 1, 1]}, None),
    "DIMS": ({"DIMS": 24}, None),
    "DIMS_latent": ({"DIMS": [16, 32, 64, 128, 256]}, lambda m: m.core_mag.has_latent),
    "SSM_D_STATE": ({"SSM_D_STATE": 2}, None),
    "SSM_RATIO": ({"SSM_RATIO": 1.0}, None),
    "SSM_DT_RANK": ({"SSM_DT_RANK": 3}, None),
    "SSM_ACT_LAYER": ({"SSM_ACT_LAYER": "gelu"}, lambda m: all(
        s.act is F.gelu for s in _of(m, SS2D))),
    "SSM_CONV": ({"SSM_CONV": 5}, None),
    "SSM_CONV_BIAS": ({"SSM_CONV_BIAS": False}, None),
    "SSM_DROP_RATE": ({"SSM_DROP_RATE": 0.2}, lambda m: all(
        s.dropout.rate == 0.2 for s in _of(m, SS2D))),
    "MLP_RATIO": ({"MLP_RATIO": 2.0}, None),
    "MLP_ACT_LAYER": ({"MLP_ACT_LAYER": "silu"}, lambda m: all(
        s.act is F.silu for s in _of(m, Mlp))),
    "MLP_DROP_RATE": ({"MLP_DROP_RATE": 0.1}, lambda m: all(
        s.drop.rate == 0.1 for s in _of(m, Mlp)) and _of(m, Mlp)),
    "GMLP": ({"GMLP": True}, lambda m: _of(m, GMlp) and not _of(m, Mlp)),
    "DROP_PATH_RATE": ({"DROP_PATH_RATE": 0.3}, lambda m: np.isclose(
        max(d.rate for d in _of(m, DropPath)), 0.3)),
    "PATCH_NORM": ({"PATCH_NORM": False}, None),
    "PATCHEMBED": ({"PATCHEMBED": "v1"}, None),
    "OUTPUT_v2": ({"OUTPUT": "v2"}, None),
    "OUTPUT_v1": ({"OUTPUT": "v1"}, None),
    "CONCAT_SKIP": ({"CONCAT_SKIP": False}, lambda m: m.phase_decoders_used),
    "USE_CHECKPOINT": ({"USE_CHECKPOINT": True}, lambda m: all(
        b.use_checkpoint for b in _of(m, VSSBlock))),
    "INTERACT_single": ({"INTERACT": "single"}, lambda m: m.core_phase is None),
    "INTERACT_p2m": ({"INTERACT": "p2m"}, lambda m: m.interact == "p2m"),
    "INTERACT_m2p": ({"INTERACT": "m2p"}, lambda m: m.interact == "m2p"),
    "PHASE_DECODER_FIX": ({"PHASE_DECODER_FIX": True}, lambda m: m.phase_decoders_used),
    "FUSE_STREAMS": ({"FUSE_STREAMS": True}, lambda m: m.fuse_streams),
    "SCAN_FP32_IO": ({"SCAN_FP32_IO": True}, lambda m: all(
        s.scan_fp32_io for s in _of(m, SS2D))),
    "NAME_VM_ASR_BASIC": ({"NAME": "VM_ASR_BASIC"}, lambda m: isinstance(m, MambaUNet)),
    "NAME_MambaUNet_v1": ({"NAME": "MambaUNet", "OUTPUT": "v1", "DIMS": [16, 32, 64, 128, 256]},
                          lambda m: isinstance(m, MambaUNet)),
}


def _configs(overrides):
    cs = []
    for c in (default_config(), jax_default_config()):
        _tiny(c)
        for k, v in overrides.items():
            if k == "NAME":
                c.MODEL.NAME = v
            else:
                c.MODEL.VSSM[k] = v
        cs.append(c)
    return cs


class _Recorder:
    """A config node that records the keys read from it."""

    def __init__(self, node):
        self._node, self.seen = node, set()

    def __getattr__(self, key):
        self.seen.add(key)
        return getattr(self._node, key)

    def get(self, key, default=None):
        self.seen.add(key)
        return self._node.get(key, default)


def _vssm_keys_read(fn, config):
    rec = _Recorder(config.MODEL.VSSM)
    proxy = types.SimpleNamespace(
        MODEL=types.SimpleNamespace(NAME=config.MODEL.NAME, VSSM=rec), DATA=config.DATA,
        TRAIN=config.TRAIN, DTYPE=config.DTYPE, AMP_ENABLE=config.AMP_ENABLE)
    fn(proxy)
    return rec.seen


def test_every_jax_option_is_read_and_tested():
    """The port's generator_kwargs and to_stacked read every MODEL.VSSM key
    the JAX factory reads (its generator kwargs, get_model and to_stacked),
    and OPTIONS sets each of them away from its default."""
    c = _tiny(jax_default_config())
    jax_keys = _vssm_keys_read(jax_factory._generator_kwargs, c) | {
        "INTERACT", "PHASE_DECODER_FIX", "FUSE_STREAMS", "SCAN_FP32_IO", "STACKED_EXECUTION"}
    port_keys = _vssm_keys_read(generator_kwargs, _tiny(default_config())) | \
        _vssm_keys_read(lambda cfg: to_stacked(cfg, None), _tiny(default_config()))
    assert jax_keys <= port_keys, jax_keys - port_keys
    tested = {k for opts, _ in OPTIONS.values() for k in opts} | {"STACKED_EXECUTION",
                                                                   "PATCH_SIZE"}
    assert jax_keys <= tested, jax_keys - tested


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_honoured(option):
    """The port builds, for the option's value, the JAX model's parameters
    (names and shapes through flax_params_to_state_dict) and the option's
    behaviour."""
    overrides, check = OPTIONS[option]
    c, cj = _configs(overrides)
    model = get_generator(c, "cpu")
    shapes = jax.eval_shape(get_model(cj)["generator"].init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, T)), jnp.array([20]))["params"]
    want = flax_params_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in want)
    if check is not None:
        assert check(model)


def test_stacked_execution_refused():
    """STACKED_EXECUTION, once refused, is not a constructor option: the
    factory builds the unstacked model (which trains) and to_stacked gives
    its stacked twin for serving (tests/test_torch_stacked_model.py)."""
    c, _ = _configs({"STACKED_EXECUTION": True})
    assert generator_kwargs(c) == generator_kwargs(_configs({})[0])
    model = get_generator(c, "cpu")
    assert type(to_stacked(c, model)).__name__ == "DualStreamStackedMambaUNet"


def test_patch_size_refused():
    """A patch size other than 4 is refused: the heads upsample by 4, so the
    JAX package's model of that size fails at its residual add."""
    c, cj = _configs({"PATCH_SIZE": 2, "PATCHEMBED": "v1"})
    with pytest.raises(ValueError, match="upsample by 4"):
        get_generator(c, "cpu")
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(get_model(cj)["generator"].init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 1, T)), jnp.array([20]))


def test_unknown_model_name_refused():
    c, _ = _configs({"NAME": "VSSM"})
    with pytest.raises(ValueError, match="Unknown model name"):
        generator_kwargs(c)


SHIPPED = sorted(p.name for p in (ROOT / "configs").glob("*.yaml"))


@pytest.mark.parametrize("cfg", SHIPPED)
def test_shipped_config_builds_through_the_cli(cfg):
    """Each shipped config through the CLI's config path (parse_option,
    get_config) builds its generator at its own widths; depth cut to 1 per
    stage. The stream-interaction ablations (SINGLE, P2M, M2P) get their
    interaction, and SINGLE no phase stream."""
    args = cli.parse_option(["--cfg", str(ROOT / "configs" / cfg), "--opts",
                             "MODEL.VSSM.DEPTHS", "[1,1,1,1]"])
    config = get_config(args)
    with torch.device("meta"):
        model = (MambaUNet if config.MODEL.NAME == "VM_ASR_BASIC"
                 else DualStreamInteractiveMambaUNet)(**generator_kwargs(config))
    assert isinstance(model, DualStreamInteractiveMambaUNet)
    want = {"vm_asr_48k_MPD_SINGLE.yaml": "single", "vm_asr_48k_MPD_P2M.yaml": "p2m",
            "vm_asr_48k_MPD_M2P.yaml": "m2p"}.get(cfg, "dual")
    assert model.interact == want
    assert (model.core_phase is None) == (want == "single")
    assert any(k.startswith("output_layer_mag.5.") for k in model.state_dict())


VARIANTS = {
    "single": ("DualStreamInteractiveMambaUNet", {"INTERACT": "single"}),
    "mamba_unet": ("VM_ASR_BASIC", {}),
    "latent": ("DualStreamInteractiveMambaUNet", {"DIMS": [16, 32, 64, 128, 256]}),
    "head_v1_patch_embed_v1": ("DualStreamInteractiveMambaUNet",
                               {"OUTPUT": "v1", "PATCHEMBED": "v1", "GMLP": True}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_checkpoint_round_trip(variant, tmp_path):
    """A variant's generator checkpoint, as the port's Trainer writes it
    (core/checkpoint.py, reference layout), loads by name into a freshly
    initialised model of the same config (compat.load_reference_checkpoint,
    what --eval and --inference use)."""
    name, overrides = VARIANTS[variant]
    c = _tiny(default_config(), name)
    for k, v in overrides.items():
        c.MODEL.VSSM[k] = v
    model = get_generator(c, "cpu", seed=1)
    CheckpointManager(str(tmp_path)).save(
        "G", GenState(model, make_optimizer(c, 10, model)), epoch=0, monitor_best=1.0,
        best=True)
    fresh = get_generator(c, "cpu", seed=2)
    assert not all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                     model.state_dict().values()))
    load_reference_checkpoint(fresh, str(tmp_path / "checkpoint-best-G.pth"))
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_single_config_through_the_cli(tmp_path, monkeypatch):
    """configs/vm_asr_48k_MPD_SINGLE.yaml through the port's CLI on the CPU,
    cut to one block per stage and a 128×64 image: train an epoch with
    validation and checkpoints, --eval the best checkpoint, --inference a
    wav; the run holds no phase stream."""
    from vm_asr_tpu_torch.dsp import save_wav

    monkeypatch.chdir(tmp_path)
    cfg = str(ROOT / "configs" / "vm_asr_48k_MPD_SINGLE.yaml")
    tiny = ["MODEL.VSSM.DEPTHS", "[1,1,1,1]", "DATA.SEGMENT", "0.315", "DATA.STFT.N_FFT",
            "256", "DATA.STFT.WIN_LENGTH", "256", "TRAIN.ADVERSARIAL.MPD_HIDDEN", "2",
            "TRAIN.ADVERSARIAL.MPD_PERIODS", "[2,3]", "DATA.VALID_SPLIT", "0.25",
            "DATA.NUM_WORKERS", "2", "TENSORBOARD.ENABLE", "False"]
    mode, trainer = cli.run(["--cfg", cfg, "--tag", "t", "--input_sr", "16000",
                             "--synthetic_data", "--synthetic_n", "8", "--batch_size", "2",
                             "--device", "cpu", "--opts", "TRAIN.EPOCHS", "1", "OUTPUT", "out",
                             *tiny])
    run_dir = tmp_path / "out" / "DualStreamInteractiveMambaUNet" / "t"
    assert mode == "train" and trainer.timings[0]["steps"] == 3
    assert trainer.gen_state.module.core_phase is None
    assert sorted(p.name for p in run_dir.glob("*.pth")) == [
        f"checkpoint-{k}-{m}.pth" for k in ("best", "latest") for m in ("G", "mpd")]
    mode, tester = cli.run(["--cfg", cfg, "--eval", "--tag", "16000_48000", "--resume",
                            str(run_dir), "--synthetic_data", "--synthetic_n", "2", "--device",
                            "cpu", "--opts", *tiny, "TEST.RESULTS_DIR", "res"])
    assert mode == "eval" and len(tester.rows) == 2
    assert all(np.isfinite(r["lsd"]) for r in tester.rows)
    save_wav("in.wav", 0.1 * np.random.default_rng(0).standard_normal(16000).astype(np.float32),
             16000)
    mode, _ = cli.run(["--cfg", cfg, "--inference", "--tag", "16000_48000", "--resume",
                       str(run_dir), "--input", "in.wav", "--device", "cpu", "--opts", *tiny,
                       "INFERENCE.RESULTS_DIR", "inf"])
    assert mode == "inference" and list((tmp_path / "inf").rglob("*.wav"))


@pytest.mark.parametrize("cfg", ["vm_asr_48k_MPD_SINGLE.yaml", "vm_asr_48k_MPD_P2M.yaml",
                                 "vm_asr_48k_MPD_M2P.yaml"])
def test_stream_config_throughput_through_the_cli(cfg, tmp_path):
    """--throughput of each stream-interaction config through the port's CLI
    on the CPU, cut to one block per stage and a 128×64 image."""
    mode, stats = cli.run(["--cfg", str(ROOT / "configs" / cfg), "--throughput",
                           "--batch_size", "2", "--device", "cpu", "--opts",
                           "MODEL.VSSM.DEPTHS", "[1,1,1,1]", "DATA.SEGMENT", "0.315",
                           "DATA.STFT.N_FFT", "256", "DATA.STFT.WIN_LENGTH", "256",
                           "TENSORBOARD.ENABLE", "False", "OUTPUT", str(tmp_path)])
    assert mode == "throughput" and stats["batch"] == 2 and stats["segments_per_second"] > 0
