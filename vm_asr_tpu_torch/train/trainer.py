"""Training engine: the epoch loop, monitoring, checkpoints and resume (port
of vm_asr_tpu/train/trainer.py; reference base/base_trainer.py:12-231 for the
loop, monitor, early stop, checkpoints and NaN kill-switch, and
trainer/trainer.py:10-495 for the losses, two optimizers, validation and
artifacts).

Quirks kept from the reference:
- MONITOR "min lsd" tracks the *training* LSD: the validation keys carry a
  `val_` prefix (reference trainer.py:314, base_trainer.py:96-115).
- Any NaN or Inf in an epoch's log ends the run with ``SystemExit(1)``
  (base_trainer.py:223-231).

One device per rank: the models' own. Under data parallelism (MESH.DP > 1,
ranks started by the CLI or torchrun) the Trainer builds the (dp, 1) mesh,
broadcasts rank 0's states to every rank, and gives the step each rank's
rows of every global batch: the training pipeline's own shard (its
``shard_index`` / ``shard_count``), or rows cut from whole batches by
``parallel.shard_batch`` (validation, and a pipeline that reads whole
batches). The schedule counts global steps (one per global batch). Only rank
0 writes logs, TensorBoard, checkpoints, profiles and ``timings``; every
rank reads the checkpoints on resume. The step's metrics stay on the
device; they
are fetched at PRINT_FREQ and at the epoch's end, so the host does not wait
for the card on every step. ``timings`` holds each epoch's host-clock
figures (seconds per step from one step's start to the next's, the time the
loop waited for the data pipeline, the epoch, validation and checkpoint
writes, and the profiled steps' device idle share when PROFILE_STEPS is on).
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ..core.checkpoint import CheckpointManager
from ..core.logging import create_logger
from ..core.profiling import count_params
from ..core.tracker import MetricTracker
from ..core.visualization import TensorboardWriter
from ..data.pipeline import batch_to_device
from ..parallel import make_mesh, process_rank, replicate_state, shard_batch
from .optim import make_optimizer
from .states import DiscState, GenState
from .steps import make_eval_step, make_train_step


def _format_epoch_table(log: Dict[str, float]) -> str:
    """Plain-text train / valid table (the reference prints it with
    PrettyTable, base_trainer.py:197-221)."""
    lines = [f"{'metric':<36} {'train':>12} {'valid':>12}", "-" * 62]
    for k in (k for k in log if not k.startswith("val_")):
        val = log.get("val_" + k)
        val_s = f"{val:12.5f}" if val is not None else " " * 12
        lines.append(f"{k:<36} {log[k]:12.5f} {val_s}")
    return "\n".join(lines)


def _fetch(metrics: List[Dict[str, Any]]) -> List[Dict[str, float]]:
    """Device metric dicts → dicts of floats, in one transfer."""
    if not metrics:
        return []
    keys = list(metrics[0])
    dev = next((v.device for m in metrics for v in m.values()
                if isinstance(v, torch.Tensor)), "cpu")
    rows = torch.stack([torch.stack([torch.as_tensor(m[k], dtype=torch.float32, device=dev)
                                     .reshape(()) for k in keys]) for m in metrics])
    return [dict(zip(keys, row)) for row in rows.tolist()]


def _busy_ms(events) -> float:
    """Length of the union of the device events' intervals, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(events):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


class Trainer:
    """Trains ``models`` ({"generator": module, discriminator name: module})
    as given, on the generator's device. The train and eval steps are the
    port's ``make_train_step`` / ``make_eval_step``, over the mesh
    ``make_mesh(config.MESH.DP)``, which raises when MESH.DP asks for more
    ranks than the process group holds."""

    def __init__(self, config, models: Dict[str, torch.nn.Module], train_loader,
                 valid_loader=None, logger=None):
        self.mesh = make_mesh(config.MESH.DP)
        self.rank0 = process_rank() == 0
        self.config = config
        self.generator = models["generator"]
        self.discriminators = {k: v for k, v in models.items() if k != "generator"}
        self.device = next(self.generator.parameters()).device
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.logger = logger or create_logger(config.OUTPUT)
        self.writer = TensorboardWriter(
            os.path.join(config.OUTPUT, "tb"), self.logger,
            enabled=config.TENSORBOARD.ENABLE and self.rank0)
        self.ckpt = CheckpointManager(config.OUTPUT)

        # Monitor (reference base_trainer.py:40-60).
        if config.MONITOR == "off":
            self.mnt_mode, self.mnt_metric = "off", None
        else:
            self.mnt_mode, self.mnt_metric = config.MONITOR.split()
        self.mnt_best = math.inf if self.mnt_mode == "min" else -math.inf
        self.early_stop = config.TRAIN.EARLY_STOPPING or math.inf
        self.start_epoch = 0
        self.timings: List[Dict[str, Any]] = []

        steps_per_epoch = max(len(train_loader), 1)
        self.gen_state = GenState(self.generator,
                                  make_optimizer(config, steps_per_epoch, self.generator))
        self.disc_states = {name: DiscState(d, make_optimizer(config, steps_per_epoch, d))
                            for name, d in sorted(self.discriminators.items())}
        self.logger.info(f"Generator params: {count_params(self.generator) / 1e6:.3f} M "
                         f"on {self.device}, mesh dp {self.mesh.dp}")
        for state in [self.gen_state, *self.disc_states.values()]:
            replicate_state(state)
        if config.TRAIN.AUTO_RESUME or config.MODEL.RESUME_PATH:
            self._try_resume()

        self.train_step = make_train_step(config, self.generator, self.discriminators,
                                          mesh=self.mesh)
        self.eval_step = make_eval_step(config, self.generator, mesh=self.mesh)
        # The epoch's artifacts are rank 0's alone: a forward of its own rows.
        self.local_eval_step = make_eval_step(config, self.generator)
        self.train_metrics, self.valid_metrics = MetricTracker(), MetricTracker()

    def _try_resume(self):
        restored = self.ckpt.restore("G", "latest", target=self.gen_state)
        if restored is None:
            return
        self.start_epoch = restored["epoch"] + 1
        self.mnt_best = restored["monitor_best"]
        for name, state in self.disc_states.items():
            self.ckpt.restore(name, "latest", target=state)
        self.logger.info(f"Resumed from epoch {self.start_epoch}")

    # ------------------------------------------------------------------ train
    def train(self) -> float:
        """The epoch loop with monitoring and early stopping
        (reference base_trainer.py:74-128)."""
        not_improved = 0
        for epoch in range(self.start_epoch, self.config.TRAIN.EPOCHS):
            t_epoch = time.perf_counter()
            timing = {"epoch": epoch}
            if self.rank0:
                self.timings.append(timing)
            log = self._train_epoch(epoch, timing)
            if self.valid_loader is not None:
                t0 = time.perf_counter()
                val_log = self._valid_epoch(epoch)
                timing["valid_s"] = time.perf_counter() - t0
                log.update(**{f"val_{k}": v for k, v in val_log.items()})

            self.logger.info(f"Epoch {epoch}:\n{_format_epoch_table(log)}")

            # NaN/Inf kill-switch (reference base_trainer.py:223-231).
            bad = [k for k, v in log.items() if not np.isfinite(v)]
            if bad:
                self.logger.error(f"Non-finite metrics {bad}; aborting run.")
                raise SystemExit(1)

            best = False
            if self.mnt_mode != "off" and self.mnt_metric in log:
                current = log[self.mnt_metric]
                improved = (current <= self.mnt_best if self.mnt_mode == "min"
                            else current >= self.mnt_best)
                if improved:
                    self.mnt_best = current
                    not_improved = 0
                    best = True
                else:
                    not_improved += 1
                if not_improved > self.early_stop:
                    self.logger.info(f"No improvement in {self.early_stop} epochs; stopping.")
                    break

            t0 = time.perf_counter()
            self._save(epoch, best)
            self.ckpt.barrier()
            timing["save_ms"] = (time.perf_counter() - t0) * 1e3
            timing["epoch_s"] = time.perf_counter() - t_epoch
            self.logger.info(f"Epoch {epoch} timing {json.dumps(timing)}")
        return self.mnt_best

    def _save(self, epoch: int, best: bool):
        freq = self.config.SAVE_EPOCH_FREQ
        epoch_copy = freq > 0 and (epoch + 1) % freq == 0
        cfg = self.config.to_dict()
        self.ckpt.save("G", self.gen_state, epoch, self.mnt_best, cfg, best=best,
                       epoch_copy=epoch_copy)
        for name, state in self.disc_states.items():
            self.ckpt.save(name, state, epoch, self.mnt_best, best=best, epoch_copy=epoch_copy)

    def _shard(self, batch, loader) -> Dict[str, Any]:
        """This rank's share of ``batch`` on the device, with its global rows:
        the loader's own shard when it reads one, else rows cut from the
        whole batch (``shard_batch``, which replicates an uneven batch)."""
        device_batch = batch_to_device(batch, self.device)
        if self.mesh.dp == 1:
            return device_batch
        count = getattr(loader, "shard_count", 1)
        if count == 1:
            return shard_batch(device_batch, self.mesh)
        if (count, loader.shard_index) != (self.mesh.dp, self.mesh.dp_rank):
            raise ValueError(f"the loader reads shard {loader.shard_index} of {count}; this "
                             f"rank is {self.mesh.dp_rank} of dp {self.mesh.dp}")
        b = device_batch["wave_input"].shape[0]
        device_batch["rows"] = (self.mesh.dp_rank * b, self.mesh.dp * b)
        return device_batch

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train_epoch(self, epoch: int, timing: Dict[str, Any]) -> Dict[str, float]:
        self.train_metrics = MetricTracker()
        self.train_loader.set_epoch(epoch)
        rng = torch.Generator(device=self.device).manual_seed(self.config.SEED * 7919 + epoch)
        n_batches = len(self.train_loader)
        pending = []  # device metric dicts, fetched at the epoch's end
        profile_steps = int(self.config.get("PROFILE_STEPS", 0) or 0)
        timing.update(step_s=[], data_wait_s=[])
        last_profiled = min(profile_steps, n_batches - 1)
        prof, prof_t0, device_batch = None, 0.0, None
        t0 = t_prev = time.perf_counter()
        for i, batch in enumerate(self.train_loader):
            timing["data_wait_s"].append(time.perf_counter() - t_prev)
            if profile_steps and i == 1 and epoch == self.start_epoch and self.rank0:
                self._sync()
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                prof.start()
                prof_t0 = time.perf_counter()
            device_batch = self._shard(batch, self.train_loader)
            self.gen_state, self.disc_states, metrics = self.train_step(
                self.gen_state, self.disc_states, device_batch, rng)
            pending.append(metrics)
            if prof is not None and i == last_profiled:
                self._sync()
                wall_ms = (time.perf_counter() - prof_t0) * 1e3
                prof.stop()
                self._record_profile(prof, timing, wall_ms, last_profiled)
                prof = None
            if i % self.config.PRINT_FREQ == 0 or i == n_batches - 1:
                m = _fetch([metrics])[0]
                self.logger.info(
                    f"Epoch {epoch} [{i + 1}/{n_batches}] loss={m['total_loss']:.4f} "
                    f"lsd={m.get('lsd', float('nan')):.4f} "
                    f"({(time.perf_counter() - t0) / (i + 1):.2f}s/it)")
            now = time.perf_counter()
            timing["step_s"].append(now - t_prev)
            t_prev = now
        timing["steps"] = len(pending)
        for m in _fetch(pending):
            for k, v in m.items():
                self.train_metrics.update(k, v)
        self.writer.set_step(epoch, "train")
        for k, v in self.train_metrics.result().items():
            self.writer.add_scalar(k, v)
        # Artifacts of the last batch's first item (reference
        # trainer.py:190-192); one more forward, so only with a writer.
        if self.writer.enabled and device_batch is not None:
            wave_out, _ = self.local_eval_step(device_batch)
            self._log_outputs(device_batch, wave_out)
        return self.train_metrics.result()

    def _record_profile(self, prof, timing, wall_ms, steps):
        """Device busy time of the profiled steps and its idle share of their
        wall time (which the profiler itself lengthens); the trace goes to
        OUTPUT/profile."""
        events = [(e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        out = os.path.join(self.config.OUTPUT, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json.gz"))
        busy = _busy_ms(events) if events else None
        timing["profile"] = dict(steps=steps, wall_ms=wall_ms, device_busy_ms=busy,
                                 device_events=len(events),
                                 idle_share=None if busy is None else 1 - busy / wall_ms)
        self.logger.info(f"profile of {steps} step(s): {json.dumps(timing['profile'])}; "
                         f"trace written to {out}")

    def _log_outputs(self, device_batch, wave_out):
        x = device_batch["wave_input"][0, 0].float().cpu().numpy()
        y = device_batch["wave_target"][0, 0].float().cpu().numpy()
        out = wave_out[0, 0].float().cpu().numpy()
        self.writer.log_outputs(x, out, y, self.config)

    def _valid_epoch(self, epoch: int) -> Dict[str, float]:
        self.valid_metrics = MetricTracker()
        device_batch, wave_out, pending = None, None, []
        for batch in self.valid_loader:
            device_batch = self._shard(batch, self.valid_loader)
            wave_out, metrics = self.eval_step(device_batch)
            pending.append(metrics)
        for m in _fetch(pending):
            for k, v in m.items():
                self.valid_metrics.update(k, v)
        self.writer.set_step(epoch, "valid")
        for k, v in self.valid_metrics.result().items():
            self.writer.add_scalar(k, v)
        # Artifacts of the last batch (reference trainer.py:304-306).
        if self.writer.enabled and device_batch is not None:
            self._log_outputs(device_batch, wave_out)
        return self.valid_metrics.result()
