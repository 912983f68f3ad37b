"""Command-line entry point of the PyTorch port: inference only.

    python -m vm_asr_tpu_torch.cli --cfg configs/vm_asr_48k_MPD.yaml --inference \
        --tag 16000_48000 --resume RUN_DIR --input file.wav [--device cuda]

Mirrors the ``--inference`` path of vm_asr_tpu/cli.py: TAG is
``{input_sr}_{target_sr}``, ``--opts KEY VALUE ...`` overrides the config,
and the generator's weights come from a reference ``*best*G*.pth`` in the
``--resume`` directory (random init from ``SEED``, with a warning, when there
is none). Runs on the card unless ``--device cpu`` is given. Training,
``--eval`` and orbax checkpoints are not ported yet.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def parse_option(argv=None):
    p = argparse.ArgumentParser("VM-ASR PyTorch port (inference)")
    p.add_argument("--cfg", type=str, required=True, metavar="FILE",
                   help="path to config yaml")
    p.add_argument("--opts", nargs="+", default=None,
                   help="override config options: KEY VALUE pairs")
    p.add_argument("--resume", type=str, default=None,
                   help="run directory holding a reference *best*G*.pth")
    p.add_argument("--disable_amp", action="store_true")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--tag", type=str, default=None)
    p.add_argument("--inference", action="store_true")
    p.add_argument("--input", type=str, default=None,
                   help="wav file or directory for --inference")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu only on request)")
    return p.parse_args(argv)


def load_generator_weights(config, generator, logger) -> None:
    """Load the first ``*best*G*.pth`` of the resume directory, if any."""
    from .compat import load_reference_checkpoint

    run_dir = config.MODEL.RESUME_PATH or config.OUTPUT
    pths = sorted(glob.glob(os.path.join(run_dir, "*best*G*.pth")))
    if pths:
        load_reference_checkpoint(generator, pths[0])
        logger.info(f"Loaded reference torch checkpoint {pths[0]}")
        return
    logger.warning(
        f"No checkpoint found in {run_dir}; using random init from SEED "
        f"{config.SEED} (the reference tolerates absent checkpoints too)"
    )


def main(argv=None) -> int:
    args = parse_option(argv)
    if not args.inference:
        raise SystemExit("only --inference is ported to PyTorch; train and "
                         "evaluate with python -m vm_asr_tpu.cli")
    if args.input is None:
        raise ValueError("--inference requires --input FILE_OR_DIR")
    if not os.path.exists(args.input):
        raise FileNotFoundError(f"--input path does not exist: {args.input}")

    from .core import create_logger, get_config, resolve_device
    from .models import get_generator
    from .train.inferencer import Inferencer

    config = get_config(args)
    logger = create_logger(config.OUTPUT)
    device = resolve_device(args.device)
    logger.info(f"Mode: inference on {device}")
    generator = get_generator(config, device)
    load_generator_weights(config, generator, logger)
    inferencer = Inferencer(config, generator, logger, device=device)
    if os.path.isdir(args.input):
        inferencer.infer_directory(args.input)
    else:
        inferencer.infer_file(args.input)
    return 0


if __name__ == "__main__":
    sys.exit(main())
