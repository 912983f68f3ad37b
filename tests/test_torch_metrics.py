"""The port's metrics (vm_asr_tpu_torch.metrics) against vm_asr_tpu.metrics,
on the CPU: the same numpy waveforms through both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vm_asr_tpu import metrics as JM
from vm_asr_tpu_torch import metrics as M

# fp32 FFT and log10 in other orders: ~1e-7 rel observed.
REL = 1e-5


def _batch(seed, b=3, t=48000):
    """A target and an output that differs from it in the high band, and
    per-sample highcut bins (of the 2048-point FFT's 1025)."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, t)).astype(np.float32)
    x = (y + 0.3 * np.diff(rng.standard_normal((b, t + 1)), axis=-1)).astype(np.float32)
    hf = np.array([341, 512, 1000][:b], np.int32)
    return x, y, hf


@pytest.mark.parametrize("name", ["snr", "lsd", "lsd_hf", "lsd_lf"])
def test_metric_matches_jax(name):
    x, y, hf = _batch(0)
    got = M.get_metrics([name])[name](torch.from_numpy(x), torch.from_numpy(y),
                                      hf=torch.from_numpy(hf).long())
    ref = JM.METRICS[name](jnp.asarray(x), jnp.asarray(y), hf=jnp.asarray(hf))
    assert abs(float(got) - float(ref)) <= REL * abs(float(ref)), (float(got), float(ref))


def test_metric_names():
    assert list(M.get_metrics(["snr", "lsd", "lsd_hf", "lsd_lf"])) == \
        list(JM.get_metrics(["snr", "lsd", "lsd_hf", "lsd_lf"]))
