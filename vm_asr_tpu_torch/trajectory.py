"""The port's training trajectory against the JAX Trainer's (the port half of
the trajectory check; the JAX half is scripts/torch_trajectory_record.py).

    python -m vm_asr_tpu_torch.trajectory [--device cuda|cpu] [--gan] [--epochs N] [--out DIR]

Loads ``artifacts/trajectory_torch`` (the replayed batches, the JAX
Trainer's seeded initial weights and its per-epoch curves), carries the
weights over with ``compat.flax_params_to_state_dict`` and
``flax_disc_variables_to_state_dict``, and runs the port's ``Trainer``
epoch by epoch on the same batches in the same order, with the JAX run's
settings: the tiny dual-stream U-Net (16 kHz, n_fft 64, depths 1-1-1-1,
dims 8·2^i, drop-path 0) in fp32 with TF32 off, AdamW at a constant 1e-3,
weight decay 0.01, L1 + multi-resolution STFT, and with ``--gan`` the MPD
(hidden 8, periods 2-3-5) with LSGAN. After each epoch the validation
batch is scored with the same numpy LSD as the JAX side. On the card the
runs take torch's deterministic algorithms (``run_arm``), so that a run
repeats bit for bit and its gaps are those of the code, not of the order of
atomic additions.

The trajectory is chaotic, so the gap to JAX is read beside two controls,
run the same way:

- the chaos floor: the port from an init with 0.05 % of the generator's
  weights moved by ±2e-3, against the port from the true init (one such
  init a run, beside the median and largest of eight recorded on the card);
- a defect the gates must catch (``DEFECT``): the port at half the
  learning rate, against JAX.

A column passes when its worst gap to JAX is within its gate (``gates``):
its bar (``BARS``), or where the port's own chaos floor as recorded on the
card (``RECORDED_FLOORS``, fixed constants) reaches above the bar, the
largest recorded floor. A bar below the recorded floor would fail the port
against itself; the summary lists such bars as ``bars_below_floor`` and the
columns where the port's gap exceeds the bar as ``over_bar``.

Writes ``torch_{arm}.csv`` (the port's curve), ``overlay_{arm}.csv`` (JAX
and the port side by side) and ``gaps_{arm}.json`` (the worst relative gap
per column for the run, the floor and the defect, the bars and gates, and
the scan kernels' launches over the three runs) to
``--out``. Exits 1 when a column's gap to JAX exceeds its gate, or when the
defect's exceeds none (a gate that lets the defect through proves nothing).
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .compat import flax_disc_variables_to_state_dict, flax_params_to_state_dict
from .core import default_config
from .core.device import resolve_device
from .models import get_discriminators, get_generator

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts" / "trajectory_torch"

# The geometry of scripts/trajectory_overlay.py.
SR, N_FFT, HOP, WIN, SAMPLES = 16000, 64, 16, 64, 16 * 255
DEPTHS, DIMS = [1, 1, 1, 1], 8
MPD_HIDDEN, MPD_PERIODS = 8, [2, 3, 5]

# Worst relative gap per column over the epochs, port against JAX: the
# reference torch Trainer's gaps against JAX in artifacts/trajectory_r5
# (no-GAN 0.72 % and 2.98 %, GAN 9.2 % and 4.4 %), rounded up. disc_loss and
# adv are reported without a bar.
BARS = {"nogan": {"total_loss": 0.010, "val_lsd": 0.030},
        "gan": {"total_loss": 0.092, "val_lsd": 0.044}}
# The chaos floor: the port from an init with PERTURB_SHARE of the
# generator's weights moved by ±PERTURB_BY, against the port from the true
# init; a run prints the largest gap of FLOOR_SEEDS' perturbations (the
# gates come from RECORDED_FLOORS, so one keeps the run short).
PERTURB_SHARE, PERTURB_BY = 5e-4, 2e-3
FLOOR_SEEDS = (0,)
# The floor per column as recorded on an NVIDIA H100 80GB HBM3 (700 W) with
# the deterministic algorithms, seeds 0-7, by
# ``python scripts/torch_trajectory_controls.py floor [--gan] --device cuda``:
# (median, largest) worst relative gap over 12 epochs.
# Rounded up at 1e-4. The port's own gaps reach above the bars there, so
# such a bar (``bars_below_floor``) would fail a right trainer.
RECORDED_FLOORS = {"nogan": {"total_loss": (0.0214, 0.0321), "val_lsd": (0.0269, 0.0487)},
                   "gan": {"total_loss": (0.0665, 0.1028), "val_lsd": (0.0239, 0.0380)}}
# The defect the gates must catch, as config overrides: half the learning
# rate, the smallest defect tried that broke a gate in both arms on the card
# and on the CPU (``scripts/torch_trajectory_controls.py defects``; AdamW's
# beta2 from 0.999 down to 0.8 and a tenfold weight decay stay inside the
# chaos at 12 epochs, PERF.md §6).
DEFECT = {"TRAIN.BASE_LR": 5e-4}

# The Trainers' per-step log lines are not wanted here.
_QUIET = logging.getLogger("vm_asr_tpu_torch.trajectory")
_QUIET.addHandler(logging.NullHandler())
_QUIET.propagate = False


def load_artifact():
    """(batches, val, init, {"nogan": rows, "gan": rows}) of the recording in
    ARTIFACT: batches and val as (input, target, highcut) numpy triples,
    init as the flat ``:``-joined flax paths, rows as per-epoch dicts of
    floats."""
    path = ARTIFACT
    with np.load(path / "data.npz") as d:
        batches = list(zip(d["inp"], d["tgt"], d["hc"]))
        val = (d["val_inp"], d["val_tgt"], d["val_hc"])
    with np.load(path / "init.npz") as d:
        init = {k: d[k] for k in d.files}
    curves = {}
    for arm in BARS:
        with open(path / f"jax_{arm}.csv") as f:
            curves[arm] = [{k: float(v) for k, v in row.items()} for row in csv.DictReader(f)]
    return batches, val, init, curves


def _unflatten(flat: Dict[str, np.ndarray], prefix: str) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        head, *path = key.split(":")
        if head != prefix:
            continue
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


def config(gan: bool, out: str, overrides: Optional[dict] = None):
    """The port's config of the JAX recording's Trainer."""
    c = default_config()
    c.MODEL.NAME = "DualStreamInteractiveMambaUNet"
    c.MODEL.VSSM.DIMS = DIMS
    c.MODEL.VSSM.DEPTHS = DEPTHS
    c.MODEL.VSSM.DROP_PATH_RATE = 0.0
    c.DATA.TARGET_SR = SR
    c.DATA.SEGMENT = SAMPLES / SR
    c.DATA.BATCH_SIZE = 4
    c.DATA.STFT.N_FFT = N_FFT
    c.DATA.STFT.HOP_LENGTH = HOP
    c.DATA.STFT.WIN_LENGTH = WIN
    c.TRAIN.LOW_FREQ_REPLACEMENT = True
    c.AMP_ENABLE = False
    c.DTYPE.COMPUTE = "float32"
    c.TRAIN.BASE_LR = 1e-3
    c.TRAIN.WEIGHT_DECAY = 0.01
    c.TRAIN.WARMUP_EPOCHS = 0
    c.TRAIN.LR_SCHEDULER.NAME = "multistep"
    c.TRAIN.LR_SCHEDULER.MULTISTEPS = []  # constant LR
    c.TRAIN.LOSSES.GEN = ["l1", "multi_resolution_stft"]
    c.TRAIN.ADVERSARIAL.ENABLE = gan
    c.TRAIN.ADVERSARIAL.DISCRIMINATORS = ["mpd"] if gan else [""]
    c.TRAIN.ADVERSARIAL.GAN_LOSS_TYPE = "lsgan"
    c.TRAIN.ADVERSARIAL.DISC_INPUT_GAIN = 1.0
    c.TRAIN.ADVERSARIAL.MPD_HIDDEN = MPD_HIDDEN
    c.TRAIN.ADVERSARIAL.MPD_PERIODS = MPD_PERIODS
    c.MONITOR = "off"
    c.MESH.DP = 1
    c.OUTPUT = out
    c.TENSORBOARD.ENABLE = False
    for key, value in (overrides or {}).items():
        node = c
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        node[leaf] = value
    return c


def perturb(model: torch.nn.Module, seed: int = 0) -> None:
    """Move PERTURB_SHARE of ``model``'s parameters by ±PERTURB_BY, drawn
    from ``seed`` on the host in name order."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            hit = rng.random(p.shape) < PERTURB_SHARE
            step = PERTURB_BY * np.where(rng.random(p.shape) < 0.5, -1.0, 1.0) * hit
            p.add_(torch.from_numpy(step.astype(np.float32)).to(p.device))


class ReplayLoader:
    """The recorded batches in their order every epoch, in the Trainer's
    loader protocol (len, set_epoch, batches with wave_input, wave_target
    and highcut)."""

    class _Batch:
        def __init__(self, wave_input, wave_target, highcut):
            self.wave_input, self.wave_target, self.highcut = wave_input, wave_target, highcut

    def __init__(self, batches):
        self._batches = [self._Batch(*b) for b in batches]

    def __len__(self):
        return len(self._batches)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self._batches)


def lsd_np(out: np.ndarray, tgt: np.ndarray) -> float:
    """Full-band LSD of scripts/trajectory_overlay.py:lsd_np (log10 power
    spectrogram, n_fft 512, hop 128, Hann window), in numpy, so that both
    frameworks' outputs are scored by one function."""
    def spec(x):
        n_fft, hop = 512, 128
        win = np.hanning(n_fft + 1)[:-1]
        pad = np.pad(x, ((0, 0), (n_fft // 2, n_fft // 2)), mode="reflect")
        frames = [np.fft.rfft(pad[:, s:s + n_fft] * win, axis=-1)
                  for s in range(0, pad.shape[-1] - n_fft + 1, hop)]
        return np.log10(np.maximum(np.abs(np.stack(frames, axis=-1)) ** 2, 1e-10))

    a, b = spec(out.reshape(out.shape[0], -1)), spec(tgt.reshape(tgt.shape[0], -1))
    return float(np.mean(np.sqrt(np.mean((a - b) ** 2, axis=1))))


def run_arm(gan: bool, epochs: int, device, data, overrides: Optional[dict] = None,
            perturb_seed: Optional[int] = None, deterministic: bool = True
            ) -> List[Dict[str, float]]:
    """The port's Trainer for ``epochs`` epochs on ``device`` from the
    initial weights of ``data`` (``load_artifact``'s result), moved by
    ``perturb`` when ``perturb_seed`` is given, with ``overrides`` applied
    to the config; per-epoch rows as in the recording's CSV.

    fp32 with TF32 off; with ``deterministic``, torch's deterministic
    algorithms (cuDNN's among them) and cuBLAS's fixed workspace. They warn
    rather than raise: the backward of the reflect pads (the STFT's centre,
    the MPD's period) has no deterministic CUDA version, but adds at most two
    terms into each zeroed element, and two terms sum the same in either
    order."""
    from .train import Trainer

    dev = resolve_device(device)
    batches, (vi, vt, vhc), init, _ = data
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.benchmark, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        with tempfile.TemporaryDirectory(prefix="vm_asr_trajectory_") as out:
            cfg = config(gan, out, overrides)
            gen = get_generator(cfg, dev)
            gen.load_state_dict(flax_params_to_state_dict(_unflatten(init, "gen")), strict=True)
            if perturb_seed is not None:
                perturb(gen, perturb_seed)
            models = {"generator": gen}
            if gan:
                mpd = get_discriminators(cfg, dev)["mpd"]
                mpd.load_state_dict(flax_disc_variables_to_state_dict(_unflatten(init, "mpd")),
                                    strict=True)
                models["mpd"] = mpd
            trainer = Trainer(cfg, models, ReplayLoader(batches), None, logger=_QUIET)
            val = {"wave_input": torch.from_numpy(vi).to(dev),
                   "wave_target": torch.from_numpy(vt).to(dev),
                   "highcut": torch.from_numpy(vhc.astype(np.int64)).to(dev)}
            rows = []
            for epoch in range(1, epochs + 1):
                log = trainer.train_epoch(epoch)
                wave_out, _ = trainer.eval_step(val)
                row = {"epoch": float(epoch), "total_loss": float(log["total_loss"]),
                       "val_lsd": lsd_np(wave_out.float().cpu().numpy(), vt)}
                if gan:
                    row["disc_loss"] = float(log["total_disc_loss"])
                    row["adv"] = float(log["generator/adversarial_mpd"])
                rows.append(row)
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = saved[:3]
        torch.use_deterministic_algorithms(saved[3], warn_only=saved[4])
    return rows


def worst_gaps(rows, ref_rows) -> Dict[str, float]:
    """Worst relative gap per column over the epochs both have:
    max |row − ref| / |ref|."""
    keys = [k for k in ref_rows[0] if k != "epoch"]
    return {k: max(abs(r[k] - q[k]) / max(abs(q[k]), 1e-9) for r, q in zip(rows, ref_rows))
            for k in keys}


def gates(arm: str) -> Dict[str, float]:
    """Each barred column's gate: its bar, or the largest recorded chaos
    floor where that lies above the bar."""
    return {k: max(bar, RECORDED_FLOORS[arm][k][1]) for k, bar in BARS[arm].items()}


def bars_below_floor(arm: str) -> List[str]:
    """The columns whose bar lies below the largest recorded chaos floor."""
    return [k for k, bar in BARS[arm].items() if RECORDED_FLOORS[arm][k][1] > bar]


def broken(gaps: Dict[str, float], gate: Dict[str, float]) -> List[str]:
    """The columns whose gap exceeds its gate."""
    return [k for k, g in gate.items() if not gaps[k] <= g]


def judge(arm: str, gap: Dict[str, float], defect_gap: Dict[str, float]) -> dict:
    """The verdict on an arm from the port's and the defect's gaps to JAX:
    the columns the port breaks (``broken``), those the defect breaks,
    whether it broke any (``caught``), and ``ok``: the port breaks no gate
    and the defect breaks one."""
    gate = gates(arm)
    defect_broken = broken(defect_gap, gate)
    out = dict(gate=gate, broken=broken(gap, gate), defect_broken=defect_broken,
               caught=bool(defect_broken))
    out["ok"] = not out["broken"] and out["caught"]
    return out


def write_csv(path, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        keys = list(rows[0])
        w.writerow(keys)
        for row in rows:
            w.writerow([int(row["epoch"]) if k == "epoch" else f"{row[k]:.8g}" for k in keys])


def _launches() -> Dict[str, int]:
    """The scan wrappers' launch counts (0 on the CPU, where none launches)."""
    from .ops import (linear_recurrence, linear_recurrence_reverse, selective_scan_fused,
                      selective_scan_fused_bwd)

    return {fn.__name__: fn.launches for fn in (selective_scan_fused, selective_scan_fused_bwd,
                                                linear_recurrence, linear_recurrence_reverse)}


def compare(gan: bool, epochs: int, device="cuda", out=None) -> dict:
    """The port's run, the chaos floor and the defect, against the
    recording; writes the CSVs and the gaps when ``out`` is given and
    returns the summary: ``ok`` is False when a column's gap to JAX exceeds
    its gate or when the defect's gap exceeds none
    (``defect["caught"]``)."""
    arm = "gan" if gan else "nogan"
    data = load_artifact()
    jax_rows = data[3][arm][:epochs]
    if len(jax_rows) < epochs:
        raise ValueError(f"the recording has {len(jax_rows)} epochs of the {arm} arm")
    before = _launches()
    t0 = time.perf_counter()
    rows = run_arm(gan, epochs, device, data)
    seconds = time.perf_counter() - t0
    floors = [worst_gaps(run_arm(gan, epochs, device, data, perturb_seed=seed), rows)
              for seed in FLOOR_SEEDS]
    floor = {k: max(f[k] for f in floors) for k in floors[0]}
    defect_rows = run_arm(gan, epochs, device, data, overrides=DEFECT)
    gap = worst_gaps(rows, jax_rows)
    defect_gap = worst_gaps(defect_rows, jax_rows)
    verdict = judge(arm, gap, defect_gap)
    summary = dict(arm=arm, epochs=epochs, device=str(resolve_device(device)),
                   bars=BARS[arm], gap=gap, over_bar=[k for k, b in BARS[arm].items()
                                                      if not gap[k] <= b],
                   bars_below_floor=bars_below_floor(arm), chaos_floor=floor, chaos_floors=floors,
                   recorded_floors=RECORDED_FLOORS[arm], gate=verdict["gate"],
                   broken=verdict["broken"],
                   defect=dict(overrides=DEFECT, gap=defect_gap, broken=verdict["defect_broken"],
                               caught=verdict["caught"]),
                   ok=verdict["ok"], seconds_per_run=seconds,
                   final={"jax": jax_rows[-1], "torch": rows[-1]},
                   launches={k: n - before[k] for k, n in _launches().items()})
    if out is not None:
        os.makedirs(out, exist_ok=True)
        write_csv(os.path.join(out, f"torch_{arm}.csv"), rows)
        overlay = [{"epoch": r["epoch"], **{f"jax_{k}": q[k] for k in q if k != "epoch"},
                    **{f"torch_{k}": r[k] for k in r if k != "epoch"}}
                   for r, q in zip(rows, jax_rows)]
        write_csv(os.path.join(out, f"overlay_{arm}.csv"), overlay)
        with open(os.path.join(out, f"gaps_{arm}.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return summary


def report(summary: dict) -> str:
    arm, lines = summary["arm"], []

    def recorded(k):
        if k not in summary["recorded_floors"]:
            return ""
        median, largest = summary["recorded_floors"][k]
        return f", recorded median {median:.2%}, largest {largest:.2%}"

    for k, gap in summary["gap"].items():
        bar, gate = BARS[arm].get(k), summary["gate"].get(k)
        limits = "no bar" if bar is None else f"bar {bar:.1%}, gate {gate:.4%}" + (
            ", the bar below the recorded floor" if k in summary["bars_below_floor"] else "")
        lines.append(f"  {k}: worst rel gap {gap:.4%} ({limits}; chaos floor "
                     f"{summary['chaos_floor'][k]:.4%}{recorded(k)}; defect "
                     f"{summary['defect']['gap'][k]:.4%})")
    head = (f"{arm}: {summary['epochs']} epochs on {summary['device']}, "
            f"{summary['seconds_per_run']:.1f} s a run; over the bar: "
            f"{summary['over_bar'] or 'none'}; defect {summary['defect']['overrides']} breaks "
            f"the gate of {summary['defect']['broken'] or 'no column'}")
    faults = ([f"over the gate {summary['broken']}"] if summary["broken"] else []) + (
        [] if summary["defect"]["caught"] else ["the defect breaks no gate"])
    verdict = "ok" if summary["ok"] else "FAILED: " + "; ".join(faults)
    return "\n".join([head, *lines, f"  {verdict}"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--gan", action="store_true")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--out", default=os.path.join("build", "trajectory"))
    args = ap.parse_args(argv)
    summary = compare(args.gan, args.epochs, args.device, args.out)
    print(report(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
