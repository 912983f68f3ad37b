"""Command-line entry point of the PyTorch port (port of vm_asr_tpu/cli.py;
reference main.py:28-92):

    python -m vm_asr_tpu_torch.cli --cfg configs/vm_asr_48k_MPD.yaml --tag 48k_MPD
    python -m vm_asr_tpu_torch.cli --cfg ... --eval --tag 16000_48000 --resume RUN_DIR
    python -m vm_asr_tpu_torch.cli --cfg ... --inference --tag 16000_48000 \
        --resume RUN_DIR --input file.wav
    python -m vm_asr_tpu_torch.cli --cfg ... --throughput [--batch_size 4]

Modes: train (the default), ``--eval``, ``--inference`` and ``--throughput``.
``--opts KEY VALUE ...`` overrides the config; ``--input_sr N`` collapses the
random input rate to N (the reference's specialised models); TAG is
``{input_sr}_{target_sr}`` for eval and inference (reference main.py:239-283).
Training writes reference-layout ``checkpoint-*-{G,mpd}.pth`` files to
OUTPUT/MODEL.NAME/TAG and resumes from them; eval and inference load the
run's ``*best*G*.pth`` (or its latest). Everything runs on the card unless
``--device cpu`` is given. A run of the JAX package (orbax checkpoints)
becomes such a run folder with ``scripts/jax_checkpoint_to_pth.py``, on a
machine with JAX. Training on VCTK reads the trimmed wav tree under
DATA.DATA_PATH, converted from the raw FLAC corpus at first use.

Training on several devices: ``--opts MESH.DP n`` with n > 1 starts n ranks
(spawned processes, one card each, NCCL) and each trains on its share of
every global batch of DATA.BATCH_SIZE; ``MESH.DP -1`` (the default) takes
every card present, which on a one-card machine is one process and no
process group. Where fewer cards are present than MESH.DP asks for, it
raises. With ``--device cpu`` the n ranks run on the host over gloo. Under
``torchrun`` (RANK and WORLD_SIZE set) each process joins torchrun's
group as its rank, on card LOCAL_RANK. ``--eval``, ``--inference`` and
``--throughput`` run in one process, as the JAX package's Tester and
Inferencer do.
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np


def parse_option(argv=None):
    p = argparse.ArgumentParser("VM-ASR PyTorch port: train / eval / infer / throughput")
    p.add_argument("--cfg", type=str, required=True, metavar="FILE",
                   help="path to config yaml")
    p.add_argument("--opts", nargs="+", default=None,
                   help="override config options: KEY VALUE pairs")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="run directory to resume / load checkpoints from")
    p.add_argument("--accumulation_steps", type=int, default=None)
    p.add_argument("--disable_amp", action="store_true")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--tag", type=str, default=None)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--inference", action="store_true")
    p.add_argument("--throughput", action="store_true")
    p.add_argument("--optim", type=str, default=None)
    p.add_argument("--input_sr", type=int, default=None)
    p.add_argument("--target_sr", type=int, default=None)
    p.add_argument("--input", type=str, default=None,
                   help="wav file or directory for --inference")
    p.add_argument("--synthetic_data", action="store_true",
                   help="use the synthetic corpus instead of VCTK (smoke runs)")
    p.add_argument("--synthetic_n", type=int, default=64,
                   help="synthetic corpus size (with --synthetic_data)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu only on request)")
    return p.parse_args(argv)


def train_ranks(mesh_dp: int, device) -> int:
    """How many ranks a training run of MESH.DP ``mesh_dp`` starts on
    ``device``'s type: on CUDA, -1 takes every card present and more cards
    than are present raise; on the CPU, -1 is one rank and n is n ranks."""
    import torch

    if device.type != "cuda":
        ranks = 1 if mesh_dp == -1 else int(mesh_dp)
    else:
        present = torch.cuda.device_count()
        ranks = present if mesh_dp == -1 else int(mesh_dp)
        if ranks > present:
            raise ValueError(f"MESH.DP {ranks} needs {ranks} CUDA devices; {present} present")
    if ranks < 1:
        raise ValueError(f"MESH.DP must be -1 or at least 1, got {mesh_dp}")
    return ranks


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_main(rank: int, ranks: int, init_method: str, argv, backend=None) -> None:
    """One spawned rank of a data-parallel training run: on card ``rank``
    over NCCL, or on the CPU over gloo. ``backend="gloo"`` with a CUDA
    ``--device`` puts every rank on that one card instead (a harness that
    runs the ranks of a run on one card)."""
    import torch

    from .core import get_config, resolve_device
    from .parallel import init_distributed

    args = parse_option(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and backend is None:
        device = torch.device("cuda", rank)
    if device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
    init_distributed(rank, ranks, init_method, device, backend=backend)
    try:
        _run(args, get_config(args), device, "train")
    finally:
        torch.distributed.destroy_process_group()


def load_generator_weights(config, generator, logger) -> None:
    """Load the resume directory's ``*best*G*.pth``, else its
    ``checkpoint-latest-G.pth``; random init from SEED, with a warning, when
    there is neither (the reference tolerates that too, utils.py:121-129)."""
    from .compat import load_reference_checkpoint
    from .core.checkpoint import CheckpointManager

    run_dir = config.MODEL.RESUME_PATH or config.OUTPUT
    latest = os.path.join(run_dir, "checkpoint-latest-G.pth")
    path = CheckpointManager.find_best(run_dir, "G") or (latest if os.path.isfile(latest)
                                                         else None)
    if path:
        load_reference_checkpoint(generator, path)
        logger.info(f"Loaded generator checkpoint {path}")
        return
    logger.warning(f"No checkpoint found in {run_dir}; using random init from SEED "
                   f"{config.SEED}")


def _maybe_stack(config, generator, logger):
    """The stream-stacked execution model for --eval, --inference and
    --throughput when MODEL.VSSM.STACKED_EXECUTION is set (identical
    outputs, each op once for both streams), else ``generator``."""
    from .models import to_stacked

    stacked = to_stacked(config, generator)
    if stacked is not generator:
        logger.info("Stacked dual-stream execution enabled (MODEL.VSSM.STACKED_EXECUTION)")
    return stacked


def run(argv=None):
    """Parse ``argv`` and run its mode; returns (mode, result): the Trainer
    after training in this process, ``{"ranks": n}`` after a training run
    of n spawned ranks, the Tester after ``--eval``, the Inferencer after
    ``--inference``, and the timing dict of ``--throughput``."""
    args = parse_option(argv)
    if args.inference:
        # Cheap preconditions before the model is built.
        if args.input is None:
            raise ValueError("--inference requires --input FILE_OR_DIR")
        if not os.path.exists(args.input):
            raise FileNotFoundError(f"--input path does not exist: {args.input}")

    import torch

    from .core import get_config, resolve_device
    from .parallel import init_distributed

    config = get_config(args)
    device = resolve_device(args.device)
    mode = ("eval" if config.EVAL_MODE else "inference" if config.INFERENCE_MODE
            else "throughput" if config.THROUGHPUT_MODE else "train")
    if mode == "train" and not torch.distributed.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # under torchrun
            if device.type == "cuda":
                device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            init_distributed(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://",
                             device)
            try:
                return _run(args, config, device, mode)
            finally:
                torch.distributed.destroy_process_group()
        ranks = train_ranks(config.MESH.DP, device)
        if ranks > 1:
            torch.multiprocessing.start_processes(
                _rank_main, nprocs=ranks, start_method="spawn",
                args=(ranks, f"tcp://127.0.0.1:{_free_port()}",
                      list(sys.argv[1:] if argv is None else argv)))
            return mode, {"ranks": ranks}
    return _run(args, config, device, mode)


def _run(args, config, device, mode):
    import torch

    from .core import create_logger
    from .data import SyntheticVCTK, get_loaders
    from .models import get_discriminators, get_generator
    from .parallel import process_rank, world_size

    logger = create_logger(config.OUTPUT)
    logger.info(f"Mode: {mode} on {device}" +
                (f", rank {process_rank()} of {world_size()}" if world_size() > 1 else ""))

    # Seeding (reference main.py:293-298); the models and the steps take
    # their own generators, seeded from SEED.
    random.seed(config.SEED)
    np.random.seed(config.SEED)
    torch.manual_seed(config.SEED)

    generator = get_generator(config, device, seed=config.SEED)
    logger.info(f"Model: {config.MODEL.NAME}")

    dataset = None
    if args.synthetic_data:
        dataset = SyntheticVCTK(
            n_items=args.synthetic_n, sr=config.DATA.TARGET_SR,
            duration=config.DATA.SEGMENT + 0.05,
            training=not (config.EVAL_MODE or config.INFERENCE_MODE),
        )

    if config.THROUGHPUT_MODE:
        from .core.profiling import benchmark
        from .train.steps import make_forward_fn

        seg = int(config.DATA.SEGMENT * config.DATA.TARGET_SR)
        bsz = config.DATA.BATCH_SIZE
        x = torch.zeros((bsz, 1, seg), dtype=torch.float32, device=device)
        hf = torch.full((bsz,), 171, dtype=torch.int64, device=device)
        generator = _maybe_stack(config, generator, logger)
        stats = benchmark(make_forward_fn(generator), x, hf, iters=10,
                          chain=lambda out, v, h: (v + 1e-6 * out, h))
        segs_per_sec = bsz / stats["seconds_per_call"]
        stats.update(batch=bsz, segments_per_second=segs_per_sec,
                     x_real_time=segs_per_sec * config.DATA.SEGMENT, device=str(device))
        logger.info(f"throughput: {segs_per_sec:.1f} segments/s "
                    f"({stats['x_real_time']:.0f}x real-time, batch {bsz})")
        return mode, stats

    if config.INFERENCE_MODE:
        from .train.inferencer import Inferencer

        load_generator_weights(config, generator, logger)
        generator = _maybe_stack(config, generator, logger)
        inferencer = Inferencer(config, generator, logger, device=device)
        if os.path.isdir(args.input):
            inferencer.infer_directory(args.input)
        else:
            inferencer.infer_file(args.input)
        return mode, inferencer

    if config.EVAL_MODE:
        from .train.tester import Tester

        loader = get_loaders(config, logger, dataset=dataset)
        load_generator_weights(config, generator, logger)
        generator = _maybe_stack(config, generator, logger)
        target_sr, input_sr = config.TAG.split("_")[1], config.TAG.split("_")[0]
        out_dir = os.path.join(config.TEST.RESULTS_DIR, config.MODEL.NAME, target_sr, input_sr)
        tester = Tester(config, generator, loader, logger, output_dir=out_dir, device=device)
        tester.evaluate()
        return mode, tester

    # -- training --------------------------------------------------------------
    from .core.wandb_utils import finish_wandb_run, init_wandb_run
    from .train.trainer import Trainer

    models = {"generator": generator, **get_discriminators(config, device)}
    logger.info(f"Models: {list(models)}")
    wandb_run = init_wandb_run(config, logger, resume=bool(config.MODEL.RESUME_PATH))
    train_loader, valid_loader = get_loaders(config, logger, dataset=dataset,
                                             shard_index=process_rank(),
                                             shard_count=world_size())
    trainer = Trainer(config, models, train_loader, valid_loader, logger)
    try:
        trainer.train()
    finally:
        finish_wandb_run(wandb_run)
        trainer.writer.close()
    return mode, trainer


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
