"""The port stands alone: it imports neither JAX nor the JAX package (every
module, the entry points cli, checks and trajectory among them, and
chip_smoke.py), and its entry points run on the card unless the caller asks
for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vm_asr_tpu_torch import cli
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.models import get_generator
from vm_asr_tpu_torch.train import Inferencer

ROOT = Path(__file__).resolve().parents[1]

_CHECK = r"""
import importlib, pkgutil, sys
import vm_asr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vm_asr_tpu_torch.__path__, "vm_asr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "vm_asr_tpu"))
entry_points = {"vm_asr_tpu_torch.trajectory", "vm_asr_tpu_torch.cli", "vm_asr_tpu_torch.checks"}
print(len(names), bad, sorted(entry_points - set(names)))
sys.exit(1 if bad or len(names) < 20 or not entry_points <= set(names) else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _tiny_config():
    c = default_config()
    c.MODEL.NAME = "DualStreamInteractiveMambaUNet"
    c.MODEL.VSSM.DEPTHS = [1, 1, 1, 1]
    return c


def test_entry_points_default_to_the_card(tmp_path):
    """get_generator, Inferencer and the CLI default to device "cuda": with
    no CUDA they raise rather than fall back to the CPU."""
    c = _tiny_config()
    if torch.cuda.is_available():
        assert next(get_generator(c).parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_generator(c)
    gen = get_generator(c, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Inferencer(c, gen, output_dir=str(tmp_path))
    wav = tmp_path / "x.wav"
    from vm_asr_tpu_torch.dsp import save_wav

    save_wav(str(wav), np.zeros(100, np.float32), 16000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--cfg", str(ROOT / "configs/vm_asr_48k_MPD.yaml"), "--inference",
                  "--tag", "16000_48000", "--input", str(wav),
                  "--output", str(tmp_path / "logs")])


def test_generator_init_is_seeded():
    c = _tiny_config()
    a = get_generator(c, device="cpu", seed=3).state_dict()
    b = get_generator(c, device="cpu", seed=3).state_dict()
    d = get_generator(c, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], d[k]) for k in a)
