"""The VMamba classifier as a configuration of the port (MODEL.TYPE "vssm":
``models.build_classifier``, ``train.Classifier``), on the CPU: the
configuration-built classifier against the benchmark's plain reference
(``benchmark/reference/vssm.py``) on seeded weights; the published v0 tiny
configuration's parameter count against the JAX package's ``VSSM``;
``Classifier.classify`` against the model's own forward; and the
classifier's keys leaving every shipped VM-ASR configuration's generator
as it was."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmark.kinds.classify_images import synth_images
from benchmark.reference import vssm as ref_vssm
from benchmark.reference.precision import Products
from benchmark.weights import make_state
from vm_asr_tpu.models import VSSM as JaxVSSM
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.core.config import CfgNode, load_config
from vm_asr_tpu_torch.models import VSSM, build_classifier, classifier_kwargs, generator_kwargs
from vm_asr_tpu_torch.train import Classifier
from vm_asr_tpu_torch.train.classifier import IMAGENET_MEAN, IMAGENET_STD

from torch_threads import one_torch_thread  # noqa: F401
from torch_vssm import FP32_REL, rel

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = json.loads((ROOT / "benchmark/configs/vssm_tiny.json").read_text())["program"]
# The small size: every part of the published model (v1 patch embed, no
# MLP, d_state 16 on the general-N route, three merges), at dims 16 and
# 32² images.
SMALL = {"MODEL": {"NUM_CLASSES": 10, "VSSM": {"DIMS": 16, "DEPTHS": [1, 1, 2, 1]}},
         "DATA": {"IMG_SIZE": 32}, "AMP_ENABLE": False}


def _config(over=None) -> CfgNode:
    c = default_config()
    c.merge_from_dict(PUBLISHED)
    c.merge_from_dict(over or {})
    return c


def _cfg_dict(over=None) -> dict:
    return _config(over).to_dict()


def _images(batch=3, size=32, seed=0) -> torch.Tensor:
    return synth_images(batch, size, torch.Generator().manual_seed(seed), "cpu")


def test_config_built_classifier_matches_the_reference():
    """fp32, seeded weights: the classifier the factory builds from the
    configuration, served through ``Classifier.classify``, against the plain
    reference on the same uint8 images. FP32_REL (tests/torch_vssm.py): the
    same fp32 maths in other orders (the general-N route's Δ·u, then ·B,
    against the reference's products, its sums over the states and the
    einsums' reductions), as the JAX parity tests of the classifier allow."""
    config = _config(SMALL)
    ref = ref_vssm.VSSM(_cfg_dict(SMALL), Products("fp32"))
    state = make_state(ref, 11, "cpu")
    ref.load_state_dict(state)
    model = build_classifier(config, "cpu", seed=3)
    model.load_state_dict(state)
    assert isinstance(model, VSSM) and not model.training
    assert not any(b.mlp_branch for s in model.stages for b in s.blocks)
    assert model.patch_embed.version == "v1" and model.stages[0].blocks[0].op.d_state == 16
    images = _images()
    got = Classifier(config, model, device="cpu").classify(images).logits
    want = ref_vssm.logits(ref.eval(), images, rows=2)
    assert got.shape == (3, 10) and got.dtype == torch.float32
    assert rel(got.numpy(), want.numpy()) < FP32_REL


def test_published_parameter_count_matches_jax():
    """The published v0 tiny configuration through ``classifier_kwargs``
    on the meta device: 22,893,448 parameters (VMamba publishes 22.9 M),
    the JAX package's ``VSSM`` with the same arguments to the parameter."""
    kwargs = classifier_kwargs(_config())
    assert kwargs["dims"] == 96 and kwargs["depths"] == (2, 2, 9, 2)
    assert kwargs["ssm_d_state"] == 16 and kwargs["mlp_ratio"] == 0.0
    assert kwargs["patchembed_version"] == "v1" and kwargs["compute_dtype"] == torch.bfloat16
    with torch.device("meta"):
        port = sum(p.numel() for p in VSSM(**kwargs).parameters())
    jm = JaxVSSM(**{k: v for k, v in kwargs.items()
                    if k not in ("compute_dtype", "scan_fp32_io")}, scan_impl="ref")
    # Parameters do not depend on the image's size: a 32² image traces fast.
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert port == jax_count == 22_893_448


def test_classify_is_the_models_forward():
    """The logits are the model's forward on the images normalised with
    ImageNet's mean and std, bit for bit, in fp32 on the host; the top-5
    ids are the logits' five largest, best first."""
    config = _config(SMALL)
    model = build_classifier(config, "cpu", seed=5)
    images = _images(batch=4, seed=2)
    out = Classifier(config, model, device="cpu").classify(images.numpy())
    x = (images.float() - torch.tensor(IMAGENET_MEAN)) / torch.tensor(IMAGENET_STD)
    with torch.inference_mode():
        want = model(x)
    assert out.logits.device.type == "cpu" and torch.equal(out.logits, want)
    assert torch.equal(out.top5, want.topk(5, dim=-1).indices)
    assert (out.logits.gather(1, out.top5).diff(dim=1) <= 0).all()
    with pytest.raises(ValueError, match="uint8"):
        Classifier(config, model, device="cpu").classify(images.float())


SHIPPED = sorted(p.name for p in (ROOT / "configs").glob("*.yaml"))


@pytest.mark.parametrize("cfg", SHIPPED)
def test_classifier_keys_leave_shipped_configs_as_they_were(cfg):
    """Each shipped configuration builds the generator it built before the
    classifier's MODEL.NUM_CLASSES and DATA.IMG_SIZE (which it does not
    set, and which take their defaults): its generator's arguments do not
    move with them, and it is no classifier configuration. Its tree against
    the JAX package's: tests/test_torch_serve.py::test_config_matches_jax."""
    config = load_config(str(ROOT / "configs" / cfg))
    assert (config.MODEL.NUM_CLASSES, config.DATA.IMG_SIZE) == (1000, 224)
    other = load_config(str(ROOT / "configs" / cfg))
    other.defrost()
    other.MODEL.NUM_CLASSES, other.DATA.IMG_SIZE = 10, 32
    assert generator_kwargs(other) == generator_kwargs(config)
    with pytest.raises(ValueError, match="not a classifier configuration"):
        classifier_kwargs(config)
