"""Checkpoints with the reference's latest / best / epoch-N lifecycle (port of
vm_asr_tpu/core/checkpoint.py; reference base/base_trainer.py:130-179 and
utils/utils.py:112-178).

Each checkpoint is one torch file in the reference's layout,
``checkpoint-{latest,best,epoch-N}-{G|mpd|msd}.pth``, holding
``{state_dict, optimizer, step, epoch, monitor_best, config}``: the module's
weights under the reference's names, the optimizer with its schedule
position and accumulation buffer (``train.optim.Optimizer.state_dict``), and
the config as a plain dict. Everything in it is a tensor or a plain Python
value, so ``torch.load(weights_only=True)`` reads it, and so do the reference
loaders (the JAX package's ``compat.torch_port.load_torch_checkpoint`` and
the port's ``compat.load_reference_checkpoint``). A file is written under a
temporary name and moved into place, so a reader never sees half of one.

Under data parallelism every rank holds the same states: rank 0 writes, the
other ranks' ``save`` writes nothing, and ``barrier`` holds every rank until
rank 0's files are in place. Every rank reads (``restore``) for itself.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from .dist import process_rank, world_size


class CheckpointManager:
    def __init__(self, output_dir: str):
        self.dir = os.path.abspath(output_dir)
        os.makedirs(self.dir, exist_ok=True)

    def path(self, kind: str, model_tag: str) -> str:
        return os.path.join(self.dir, f"checkpoint-{kind}-{model_tag}.pth")

    def save(
        self,
        model_tag: str,
        state: Any,
        epoch: int,
        monitor_best: float,
        config: Optional[dict] = None,
        best: bool = False,
        epoch_copy: bool = False,
    ) -> None:
        """Write `latest`, and copies as `best` and `epoch-N` when asked
        (reference base_trainer.py:130-179). ``state`` is a
        ``train.GenState`` / ``DiscState``. Only rank 0 writes."""
        if process_rank() != 0:
            return
        blob = dict(state.state_dict(), epoch=int(epoch), monitor_best=float(monitor_best),
                    config=config)
        latest = self.path("latest", model_tag)
        tmp = f"{latest}.tmp{os.getpid()}"
        torch.save(blob, tmp)
        copies = ([self.path("best", model_tag)] if best else []) + \
            ([self.path(f"epoch-{epoch}", model_tag)] if epoch_copy else [])
        for dst in copies:
            shutil.copyfile(tmp, f"{dst}.tmp{os.getpid()}")
            os.replace(f"{dst}.tmp{os.getpid()}", dst)
        os.replace(tmp, latest)

    @staticmethod
    def barrier() -> None:
        """Under a process group, wait until every rank is here (after rank
        0's writes); a no-op in one process."""
        if world_size() > 1:
            dist.barrier()

    def load(self, model_tag: str, kind: str = "latest") -> Optional[Dict[str, Any]]:
        """The checkpoint's contents on the CPU, or None if there is none."""
        path = self.path(kind, model_tag)
        if not os.path.isfile(path):
            return None
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, model_tag: str, kind: str = "latest",
                target: Any = None) -> Optional[Dict[str, Any]]:
        """Load a checkpoint into ``target`` (a GenState / DiscState, in
        place) and return ``{"state": target, "epoch", "monitor_best",
        "config"}``; None if there is no such checkpoint."""
        blob = self.load(model_tag, kind)
        if blob is None:
            return None
        if target is not None:
            target.load_state_dict(blob)
        return {"state": target, "epoch": blob["epoch"],
                "monitor_best": blob["monitor_best"], "config": blob.get("config")}

    @staticmethod
    def find_best(path: str, model_tag: str = "G") -> Optional[str]:
        """The run folder's `*best*-<tag>` checkpoint
        (reference utils/utils.py:159-176)."""
        hits = sorted(glob.glob(os.path.join(path, f"checkpoint-best-{model_tag}.pth")))
        if not hits:
            hits = sorted(glob.glob(os.path.join(path, f"*best*{model_tag}*.pth")))
        return hits[0] if hits else None

    def has(self, model_tag: str, kind: str = "latest") -> bool:
        return os.path.isfile(self.path(kind, model_tag))
