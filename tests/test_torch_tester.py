"""The port's Tester (train/tester.py) against the JAX package's, on the CPU.

The same generator weights (JAX-initialised, carried over by
flax_params_to_state_dict), the same eval batch: one clip padded to one
segment (one forward) or one of three segments (unfold, bucketed forwards,
fold). The CSVs' headers must be identical, the metrics close, and the same
wav files written.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.models import get_model
from vm_asr_tpu.train.tester import Tester as JaxTester
from vm_asr_tpu_torch.compat import flax_params_to_state_dict
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.data import Batch, SyntheticVCTK
from vm_asr_tpu_torch.models import get_generator
from vm_asr_tpu_torch.train import Tester as PortTester
from vm_asr_tpu_torch.train.tester import COMPUTE_COLUMNS, CSV_COLUMNS
from tests.torch_native import jax_uses_port_native  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

# Metrics of the same fp32 forward in two frameworks: the outputs differ by
# ~1e-6 of their scale (tests/test_torch_model.py), the metrics' log10 and
# sqrt keep that order.
METRIC_REL = 1e-4
SEG = 2016  # 0.126 s at 16 kHz: a 64×64 image at n_fft 128, hop 32
OVERLAP = 500


def _tiny(c):
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = SEG / 16000
    c.DATA.STFT.N_FFT = 128
    c.DATA.STFT.HOP_LENGTH = 32
    c.DATA.STFT.WIN_LENGTH = 128
    c.MODEL.NAME = "DualStreamInteractiveMambaUNet"
    c.MODEL.VSSM.DIMS = 16
    c.MODEL.VSSM.DEPTHS = [1, 1, 1, 1]
    c.TAG = "8000_16000"
    c.EVAL_MODE = True
    c.TEST.OVERLAP = OVERLAP
    c.TENSORBOARD.ENABLE = False
    c.DTYPE.COMPUTE = "float32"
    c.AMP_ENABLE = False
    return c


class Loader:
    """A fixed list of eval batches (batch 1), as an eval pipeline gives
    them."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _clip(t, pad, seed):
    """One eval batch of ``t`` samples. The input has the Nyquist offset of
    tests/test_torch_model.py::_wave, and is zero over the first n_fft
    samples of every segment window and the last n_fft of the clip: where
    the centred STFT's first frame of a window is not zero, it is
    symmetric, so its spectrum is real, and angle() of its negative bins is
    +π in one FFT and −π in the other, a difference the phase stream carries
    to the output. (The two packages' eval pipelines are held bitwise equal
    in tests/test_torch_data.py.)"""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 0.1, t) + 0.2 * (-1.0) ** np.arange(t)
    for start in range(0, t - SEG + 1, SEG - OVERLAP):
        x[start:start + 128] = 0.0
    x[-128:] = 0.0
    y = SyntheticVCTK(1, 16000, t / 16000, seed=seed, training=False).load(0)[0][:t]
    return Batch(wave_input=x.astype(np.float32)[None, None],
                 wave_target=y[None, None].copy(), highcut=np.array([33], np.int32),
                 names=[f"clip_{seed}.wav"], pad_lengths=np.array([pad], np.int32))


# One clip shorter than a segment, padded to one (one forward), and one of
# three segments (unfold, a bucket-4 forward, fold).
CASES = {"one_segment": (SEG, 416), "three_segments": (3 * SEG, 0)}


@pytest.fixture(scope="module")
def weights():
    cfg = _tiny(jax_default_config())
    gen = get_model(cfg)["generator"]
    params = jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, SEG), jnp.float32),
                               jnp.zeros((1,), jnp.int32))["params"]
    return cfg, gen, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, weights, tmp_path_factory):
    jcfg, jgen, params = weights
    loader = Loader([_clip(*CASES[request.param], seed=3)])
    tmp = tmp_path_factory.mktemp(request.param)
    out = {}
    cwd = os.getcwd()
    try:
        for side in ("jax", "port"):
            d = tmp / side
            d.mkdir()
            os.chdir(d)
            if side == "jax":
                tester = JaxTester(jcfg, jgen, jax.tree_util.tree_map(jnp.asarray, params),
                                   loader, output_dir=str(d / "wavs"))
            else:
                cfg = _tiny(default_config())
                model = get_generator(cfg, "cpu")
                model.load_state_dict(flax_params_to_state_dict(params), strict=True)
                tester = PortTester(cfg, model, loader, output_dir=str(d / "wavs"), device="cpu")
            log = tester.evaluate()
            out[side] = dict(log=log, csv=(d / "results_16kHz.csv").read_text().splitlines(),
                             wavs=sorted(os.listdir(d / "wavs")), tester=tester)
    finally:
        os.chdir(cwd)
    return out


def test_csv_header_identical(runs):
    want = ",".join(c.upper() for c in CSV_COLUMNS + COMPUTE_COLUMNS)
    assert runs["port"]["csv"][0] == runs["jax"]["csv"][0] == want
    assert len(runs["port"]["csv"]) == 2
    row = [float(v) for v in runs["port"]["csv"][1].split(",")]
    assert len(row) == 9 and np.isfinite(row).all() and row[0] == 8000


@pytest.mark.parametrize("metric", ["snr", "lsd", "lsd_hf", "lsd_lf", "lsd_input"])
def test_metrics_match_jax(runs, metric):
    got, ref = runs["port"]["log"][metric], runs["jax"]["log"][metric]
    assert abs(got - ref) <= METRIC_REL * abs(ref), (got, ref)


def test_same_wavs_written(runs):
    assert runs["port"]["wavs"] == runs["jax"]["wavs"]
    assert runs["port"]["wavs"] == sorted(f"clip_3_{s}.wav" for s in ("down", "orig", "up"))


def test_rtf_columns_measured(runs):
    log = runs["port"]["log"]
    for k in ("rtf", "rtf_reciprocal", "rtf_compute", "rtf_compute_reciprocal"):
        assert np.isfinite(log[k]) and log[k] > 0
    rows = runs["port"]["tester"].rows
    assert len(rows) == 1 and rows[0]["samples"] % SEG == 0
