"""Weights & Biases logging, off unless WANDB.ENABLE (port of
vm_asr_tpu/core/wandb_utils.py; reference utils/utils.py:93-109).

``wandb`` is imported only when the config enables it. Where it is not
installed, the run goes on without it after one warning, as the JAX package
does: it is a logging extra, not part of the computation. Under data
parallelism only rank 0 starts a run.
"""

from __future__ import annotations

from .dist import process_rank


def init_wandb_run(config, logger=None, resume: bool = False):
    if not config.WANDB.ENABLE or process_rank() != 0:
        return None
    try:
        import wandb
    except ImportError:
        if logger:
            logger.warning("WANDB.ENABLE is set but wandb is not installed; "
                           "logging to TensorBoard only.")
        return None

    # Mirror the TensorBoard writer's scalars to wandb (reference utils.py:100-103).
    wandb.tensorboard.patch(root_logdir=config.OUTPUT)
    return wandb.init(
        project=config.WANDB.PROJECT,
        entity=config.WANDB.ENTITY,
        group=config.MODEL.NAME,
        name=config.TAG,
        tags=list(config.WANDB.TAGS),
        mode=config.WANDB.MODE,
        resume="allow" if (resume or config.WANDB.RESUME) else None,
        config=config.to_dict(),
    )


def finish_wandb_run(run) -> None:
    if run is not None:
        run.finish()
