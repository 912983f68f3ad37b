"""The port's command line (vm_asr_tpu_torch/cli.py) on the CPU: train an
epoch, resume to a second, --eval the checkpoint, --throughput; the JAX
package's --eval reads the port's checkpoint; and without ``--device cpu``
every mode refuses to run where there is no card.

A shipped config cut to a tiny model through --opts, as
tests/test_throughput_cli.py cuts it: 16 kHz, 0.315 s segments (5040
samples, hop 80: a 64×64 image), dims 4, depths 1-1-1-1, a two-period MPD.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from vm_asr_tpu.cli import _load_generator_params as jax_load_generator_params
from vm_asr_tpu.cli import main as jax_main
from vm_asr_tpu.cli import parse_option as jax_parse_option
from vm_asr_tpu.core import get_config as jax_get_config
from vm_asr_tpu.models import get_model
from vm_asr_tpu_torch import cli
from vm_asr_tpu_torch.compat import flax_params_to_state_dict
from vm_asr_tpu_torch.core.logging import create_logger
from vm_asr_tpu_torch.data import WorkerPipeline
from vm_asr_tpu_torch.train.tester import COMPUTE_COLUMNS, CSV_COLUMNS
from tests.torch_native import jax_uses_port_native  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = str(ROOT / "configs" / "vm_asr_16k.yaml")
TINY = ["MODEL.VSSM.DIMS", "4", "MODEL.VSSM.DEPTHS", "[1,1,1,1]", "DATA.SEGMENT", "0.315",
        "DATA.STFT.N_FFT", "128", "DATA.STFT.WIN_LENGTH", "128",
        "TRAIN.ADVERSARIAL.MPD_HIDDEN", "2", "TRAIN.ADVERSARIAL.MPD_PERIODS", "[2,3]",
        "DATA.VALID_SPLIT", "0.25", "DATA.NUM_WORKERS", "2", "TENSORBOARD.ENABLE", "False"]


def _train_args(out, epochs, device=("--device", "cpu")):
    return ["--cfg", CFG, "--tag", "t", "--input_sr", "8000", "--synthetic_data",
            "--synthetic_n", "8", "--batch_size", "2", *device,
            "--opts", "TRAIN.EPOCHS", str(epochs), "OUTPUT", str(out), *TINY]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch, then a resume to the second: (run dir, both Trainers)."""
    out = tmp_path_factory.mktemp("cli")
    mode, first = cli.run(_train_args(out, 1))
    assert mode == "train"
    mode, second = cli.run(_train_args(out, 2))
    return out / "DualStreamInteractiveMambaUNet" / "t", first, second


def test_train_writes_checkpoints(trained):
    run_dir, first, _ = trained
    assert first.config.OUTPUT == str(run_dir)
    assert first.timings[0]["steps"] == 3 and len(first.valid_loader) == 1
    assert sorted(p.name for p in run_dir.glob("*.pth")) == [
        f"checkpoint-{k}-{m}.pth" for k in ("best", "latest") for m in ("G", "mpd")]
    assert first.config.DATA.RANDOM_RESAMPLE == [8000]  # --input_sr
    assert first.config.DATA.BATCH_SIZE == 2  # --batch_size


def test_resume_continues(trained):
    run_dir, first, second = trained
    assert second.start_epoch == 1 and [t["epoch"] for t in second.timings] == [1]
    assert second.gen_state.optimizer.count == 6 and second.gen_state.step == 6
    assert second.disc_states["mpd"].optimizer.count == 6
    blob = torch.load(run_dir / "checkpoint-latest-G.pth", weights_only=True)
    assert blob["epoch"] == 1 and blob["step"] == 6


def test_eval_writes_csv(trained, tmp_path):
    run_dir, _, second = trained
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        mode, tester = cli.run(["--cfg", CFG, "--eval", "--tag", "8000_16000", "--resume",
                                str(run_dir), "--synthetic_data", "--synthetic_n", "2",
                                "--device", "cpu", "--opts", *TINY,
                                "TEST.RESULTS_DIR", str(tmp_path / "results")])
    finally:
        os.chdir(cwd)
    assert mode == "eval" and len(tester.rows) == 2
    # The eval loaded the run's best generator.
    best = torch.load(run_dir / "checkpoint-best-G.pth", weights_only=True)["state_dict"]
    assert all(torch.equal(v, best[k]) for k, v in tester.generator.state_dict().items())
    lines = (tmp_path / "results_16kHz.csv").read_text().splitlines()
    assert lines[0] == ",".join(c.upper() for c in CSV_COLUMNS + COMPUTE_COLUMNS)
    row = [float(v) for v in lines[1].split(",")]
    assert len(lines) == 2 and len(row) == 9 and np.isfinite(row).all()
    wavs = sorted(os.listdir(tmp_path / "results" / "DualStreamInteractiveMambaUNet" /
                             "16000" / "8000"))
    assert wavs == sorted(f"synth_000{i}_{s}.wav" for i in (0, 1) for s in ("up", "orig", "down"))


def test_jax_eval_reads_the_port_checkpoint(trained, tmp_path):
    """The JAX package's --eval takes the port's checkpoint-best-G.pth (its
    reference-layout branch), and the params it loads are the port's."""
    run_dir, _, _ = trained
    argv = ["--cfg", CFG, "--eval", "--tag", "8000_16000", "--resume", str(run_dir),
            "--synthetic_data", "--synthetic_n", "1", "--opts", *TINY,
            "TEST.RESULTS_DIR", str(tmp_path / "results"), "TEST.COMPUTE_RTF", "False"]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert jax_main(argv) == 0
    finally:
        os.chdir(cwd)
    assert "Loaded reference torch checkpoint" in (run_dir / "log_rank0.txt").read_text()
    cfg = jax_get_config(jax_parse_option(argv))
    params = jax_load_generator_params(cfg, get_model(cfg)["generator"],
                                       create_logger(str(tmp_path)))
    got = flax_params_to_state_dict(params)
    best = torch.load(run_dir / "checkpoint-best-G.pth", weights_only=True)["state_dict"]
    assert set(got) == set(best)
    assert all(torch.equal(got[k], best[k]) for k in best)


def test_throughput_returns_zero(tmp_path):
    assert cli.main(["--cfg", CFG, "--throughput", "--batch_size", "2", "--device", "cpu",
                     "--opts", *TINY, "OUTPUT", str(tmp_path)]) == 0
    log = (tmp_path / "DualStreamInteractiveMambaUNet" / "default" / "log_rank0.txt").read_text()
    assert "Mode: throughput on cpu" in log and "segments/s" in log and "batch 2)" in log


@pytest.mark.parametrize("mode", ["train", "eval", "throughput"])
def test_card_by_default(mode, tmp_path):
    """Without --device the CLI asks for the card, and raises where there is
    none instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    argv = {"train": _train_args(tmp_path, 1, device=()),
            "eval": ["--cfg", CFG, "--eval", "--tag", "8000_16000", "--resume", str(tmp_path),
                     "--synthetic_data", "--opts", *TINY],
            "throughput": ["--cfg", CFG, "--throughput", "--opts", *TINY,
                           "OUTPUT", str(tmp_path)]}[mode]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)


def test_unported_options_refused(tmp_path):
    """The options once refused now run: STACKED_EXECUTION measures the
    stacked model's throughput (tests/test_torch_stacked_cli.py holds its
    --eval to the unstacked one); DATA.PIPELINE grain trains on the
    worker-process pipeline."""
    mode, stats = cli.run(["--cfg", CFG, "--throughput", "--device", "cpu", "--opts", *TINY,
                           "OUTPUT", str(tmp_path), "MODEL.VSSM.STACKED_EXECUTION", "True"])
    assert mode == "throughput" and stats["segments_per_second"] > 0
    mode, trainer = cli.run(_train_args(tmp_path, 1) + ["DATA.PIPELINE", "grain"])
    assert mode == "train" and isinstance(trainer.train_loader, WorkerPipeline)
    assert trainer.timings[0]["steps"] == 3 and trainer.gen_state.step == 3
