"""--eval and --inference through the port's CLI with
MODEL.VSSM.STACKED_EXECUTION on the CPU (the JAX package's
tests/test_stacked_eval_cli.py): the checkpoint's weights (here the random
init from SEED, as there) go to the stacked model, and its metrics and
enhanced audio are the unstacked model's."""

import os
from pathlib import Path

import numpy as np
import pytest

from vm_asr_tpu_torch import cli
from vm_asr_tpu_torch.dsp import save_wav
from vm_asr_tpu_torch.models import DualStreamInteractiveMambaUNet, DualStreamStackedMambaUNet
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = str(ROOT / "configs" / "vm_asr_16k_woGAN.yaml")
# HOP is derived (80 at 16 kHz): 5040 / 80 + 1 = 64 frames.
TINY = ["MODEL.VSSM.DIMS", "4", "MODEL.VSSM.DEPTHS", "[1,1,1,1]", "DATA.SEGMENT", "0.315",
        "DATA.STFT.N_FFT", "128", "DATA.STFT.WIN_LENGTH", "128", "TENSORBOARD.ENABLE", "False",
        "AMP_ENABLE", "False"]
# The stacked and unstacked forwards differ by the order of a few fp32 sums
# (tests/test_torch_stacked_model.py: 1e-6 absolute on the waveform).
REL = 1e-5


def _run(mode_args, out, stacked):
    cwd = os.getcwd()
    os.chdir(out)
    try:
        return cli.run(mode_args + ["--device", "cpu", "--opts", *TINY, "OUTPUT", str(out),
                                    "TEST.RESULTS_DIR", str(out / "results"),
                                    "INFERENCE.RESULTS_DIR", str(out / "inference"),
                                    "MODEL.VSSM.STACKED_EXECUTION", str(stacked)])
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("mode", ["eval", "inference"])
def test_cli_stacked_matches_unstacked(mode, tmp_path):
    if mode == "eval":
        args = ["--cfg", CFG, "--eval", "--tag", "8000_16000", "--synthetic_data",
                "--synthetic_n", "2"]
    else:
        clip = tmp_path / "clip_8k.wav"
        save_wav(str(clip), (0.1 * np.random.default_rng(0).standard_normal(4000))
                 .astype(np.float32), 8000)
        args = ["--cfg", CFG, "--inference", "--tag", "8000_16000", "--input", str(clip)]
    results = {}
    for stacked in (False, True):
        out = tmp_path / f"stacked_{stacked}"
        out.mkdir()
        got_mode, runner = _run(args, out, stacked)
        assert got_mode == mode
        kind = DualStreamStackedMambaUNet if stacked else DualStreamInteractiveMambaUNet
        assert type(runner.generator) is kind
        if mode == "eval":
            csv = (out / "results_16kHz.csv").read_text().splitlines()
            assert len(csv) == 2 and len(runner.rows) == 2
            results[stacked] = np.array([[r["lsd"], r["snr"], r["lsd_hf"]] for r in runner.rows])
        else:
            wavs = sorted(p.name for p in (out / "inference").rglob("*.wav"))
            assert wavs
            results[stacked] = runner.infer_file(args[-1], quiet=True).numpy()
    assert np.isfinite(results[True]).all()
    np.testing.assert_allclose(results[True], results[False], rtol=REL,
                               atol=REL * np.abs(results[False]).max())
