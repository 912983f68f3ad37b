"""Record the JAX Trainer's training trajectory for the PyTorch port to
replay: the JAX half of the port's trajectory check.

    python scripts/torch_trajectory_record.py [--epochs 12] [--out artifacts/trajectory_torch]

Runs on the CPU where JAX is installed. The geometry, data and Trainer
settings are those of ``scripts/trajectory_overlay.py`` (its ``make_data``,
replay loader and LSD are imported from there): the tiny
``DualStreamInteractiveMambaUNet`` of ``compat.parity_check.model_kwarg_pair``
(16 kHz, n_fft 64, hop 16, depths 1-1-1-1, dims 8·2^i, drop-path 0) in fp32,
AdamW at a constant 1e-3 with weight decay 0.01, L1 + multi-resolution STFT,
and in the GAN arm the MPD (hidden 8, periods 2-3-5) with LSGAN. Both arms
start from the Trainer's own seeded JAX init, rounded to float16 (``as_fp16``),
and train on the same 8 batches of 4 (seed 0) in the same order each epoch;
the validation batch (seed 999) is scored after every epoch with the numpy
LSD. Each input carries a -40 dB noise floor (``FLOOR``, ``with_floor``).

Writes to ``--out``:

- ``data.npz``: ``inp``, ``tgt``, ``hc`` (8, 4, 1, 4080) / (8, 4) and
  ``val_inp``, ``val_tgt``, ``val_hc``;
- ``init.npz``: the initial generator params (``gen:``-prefixed flax paths
  joined by ``:``) and the MPD's variables (``mpd:params:…`` and
  ``mpd:batch_stats:…``), float16;
- ``jax_nogan.csv`` and ``jax_gan.csv``: epoch, total_loss, val_lsd, and
  in the GAN arm disc_loss and adv (the epoch means of the Trainer's log);
- ``README.md``: the command, the JAX version and the seconds each arm
  took.

The port's half, ``python -m vm_asr_tpu_torch.trajectory``, replays the
same batches from the same weights and compares its curves with these.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import trajectory_overlay as overlay  # noqa: E402

N_BATCHES, BATCH, DATA_SEED, VAL_SEED = 8, 4, 0, 999
MPD_HIDDEN, MPD_PERIODS = 8, (2, 3, 5)
SEP = ":"
# White noise of this standard deviation added to each input between its
# zeroed ends. make_data's input has an empty band above the highcut, whose
# bins hold FFT rounding: each FFT library rounds them differently, and the
# generator reads their angles and log-magnitudes, so the two frameworks'
# forwards of one set of weights on make_data's batch 0 differ by 41 % of
# the largest output (3 % on average). At 1e-2 (-40 dB against the ~1.0
# signal) the band holds signal and they differ by 0.17 % (1.5e-5 on
# average): scripts/torch_trajectory_controls.py forward.
FLOOR = 1e-2
FLOOR_SEED = 5


def with_floor(batches, seed):
    """make_data's batches with FLOOR's noise added to each input."""
    rng = np.random.default_rng([FLOOR_SEED, seed])
    out = []
    for inp, tgt, hc in batches:
        inp = inp.copy()
        noise = rng.standard_normal(inp.shape).astype(np.float32) * FLOOR
        inp[..., overlay.N_FFT:-overlay.N_FFT] += noise[..., overlay.N_FFT:-overlay.N_FFT]
        out.append((inp, tgt, hc))
    return out


def as_fp16(tree):
    """Every leaf rounded to float16 and back: the init the artifact can
    store in half the bytes (the MPD alone has 1.5 M parameters), so that
    both frameworks start from exactly what the file holds."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float32).astype(np.float16).astype(np.float32)),
        tree)


def _config(epochs: int, gan: bool, out: str):
    from vm_asr_tpu.core import default_config

    c = default_config()
    c.MODEL.NAME = "DualStreamInteractiveMambaUNet"
    c.DATA.TARGET_SR = overlay.SR
    c.DATA.SEGMENT = overlay.SAMPLES / overlay.SR
    c.DATA.BATCH_SIZE = BATCH
    c.DATA.STFT.N_FFT = overlay.N_FFT
    c.DATA.STFT.HOP_LENGTH = overlay.HOP
    c.DATA.STFT.WIN_LENGTH = overlay.WIN
    c.AMP_ENABLE = False
    c.TRAIN.EPOCHS = epochs
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
    c.MONITOR = "off"
    c.OUTPUT = out
    c.TENSORBOARD.ENABLE = False
    return c


def _flatten(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield SEP.join(prefix + (str(k),)), np.asarray(jax.device_get(v), np.float16)


def run_arm(batches, val, epochs: int, gan: bool, workdir: str):
    """The JAX Trainer for ``epochs`` epochs; returns (rows, init arrays)."""
    from vm_asr_tpu.compat.parity_check import model_kwarg_pair
    from vm_asr_tpu.models.discriminator import MultiPeriodDiscriminator
    from vm_asr_tpu.models.unet import DualStreamInteractiveMambaUNet
    from vm_asr_tpu.train.trainer import Trainer

    geom = dict(n_fft=overlay.N_FFT, hop_length=overlay.HOP, win_length=overlay.WIN,
                depths=overlay.DEPTHS, dims=overlay.DIMS, samples=overlay.SAMPLES)
    _, kwargs = model_kwarg_pair(geom, 4)
    kwargs.update(dtype=jnp.float32, drop_path_rate=0.0)
    models = {"generator": DualStreamInteractiveMambaUNet(interact="dual", **kwargs)}
    if gan:
        models["mpd"] = MultiPeriodDiscriminator(hidden=MPD_HIDDEN, periods=MPD_PERIODS)
    cfg = _config(epochs, gan, os.path.join(workdir, "gan" if gan else "nogan"))
    os.makedirs(cfg.OUTPUT, exist_ok=True)
    trainer = Trainer(cfg, models, overlay.JaxReplayLoader(batches), None, mesh=None)

    trainer.gen_state = trainer.gen_state.replace(params=as_fp16(trainer.gen_state.params))
    init = dict(_flatten(trainer.gen_state.params, ("gen",)))
    if gan:
        mpd = trainer.disc_states["mpd"]
        mpd = trainer.disc_states["mpd"] = mpd.replace(
            params=as_fp16(mpd.params), batch_stats=as_fp16(mpd.batch_stats))
        init.update(_flatten({"params": mpd.params, "batch_stats": mpd.batch_stats},
                             ("mpd",)))

    vi, vt, vhc = val
    rows = []
    for epoch in range(1, epochs + 1):
        log = trainer._train_epoch(epoch)
        out, _ = trainer.eval_step(trainer.gen_state.params, {
            "wave_input": vi, "wave_target": vt, "highcut": vhc.astype(np.int32)})
        row = {"epoch": epoch, "total_loss": float(log["total_loss"]),
               "val_lsd": overlay.lsd_np(np.asarray(jax.device_get(out)), vt)}
        if gan:
            row["disc_loss"] = float(log["total_disc_loss"])
            row["adv"] = float(log["generator/adversarial_mpd"])
        rows.append(row)
        print(f"[jax {'gan' if gan else 'nogan'}] " +
              " ".join(f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in row.items()), flush=True)
    return rows, init


def write_csv(path: str, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        for row in rows:
            w.writerow({k: (f"{v:.8g}" if isinstance(v, float) else v) for k, v in row.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--out", default=os.path.join("artifacts", "trajectory_torch"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="torch_trajectory_record_")  # the Trainers' logs

    batches = with_floor(overlay.make_data(N_BATCHES, BATCH, seed=DATA_SEED), DATA_SEED)
    val = with_floor(overlay.make_data(1, BATCH, seed=VAL_SEED), VAL_SEED)[0]
    np.savez_compressed(
        os.path.join(args.out, "data.npz"),
        inp=np.stack([b[0] for b in batches]), tgt=np.stack([b[1] for b in batches]),
        hc=np.stack([b[2] for b in batches]), val_inp=val[0], val_tgt=val[1], val_hc=val[2])

    seconds, init = {}, {}
    for gan in (False, True):
        t0 = time.perf_counter()
        rows, arm_init = run_arm(batches, val, args.epochs, gan, workdir)
        seconds["gan" if gan else "nogan"] = time.perf_counter() - t0
        write_csv(os.path.join(args.out, f"jax_{'gan' if gan else 'nogan'}.csv"), rows)
        for k, v in arm_init.items():
            if k in init and not np.array_equal(init[k], v):
                raise AssertionError(f"the arms' initial {k} differ")
            init[k] = v
    np.savez_compressed(os.path.join(args.out, "init.npz"), **init)

    cmd = "python scripts/torch_trajectory_record.py" + (
        f" --epochs {args.epochs}" if args.epochs != 12 else "")
    readme = f"""# The JAX Trainer's trajectory, for the PyTorch port to replay

Written by `{cmd}` (JAX {jax.__version__}, on the CPU, fp32):
no-GAN arm {seconds['nogan']:.1f} s, GAN arm {seconds['gan']:.1f} s.
The script's docstring gives the protocol; `python -m vm_asr_tpu_torch.trajectory
[--gan] [--device cpu]` replays it in the port and compares.

- `data.npz`: the 8 training batches of 4 (`make_data` of
  `scripts/trajectory_overlay.py`, seed {DATA_SEED}) and the validation batch
  (seed {VAL_SEED}), each input with white noise of std {FLOOR} between its
  zeroed ends (the script's `FLOOR` says why).
- `init.npz`: the JAX Trainer's seeded initial generator params (`gen:…`)
  and MPD variables (`mpd:params:…`, `mpd:batch_stats:…`), flax paths
  joined by `:`, rounded to float16; both arms trained from these values.
- `jax_nogan.csv`, `jax_gan.csv`: per epoch, the epoch-mean total_loss, the
  validation batch's LSD after the epoch, and in the GAN arm the
  epoch-mean disc_loss (total_disc_loss) and adv
  (generator/adversarial_mpd).
"""
    with open(os.path.join(args.out, "README.md"), "w") as f:
        f.write(readme)
    print(f"written to {args.out}: {seconds}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
