"""Train states for the generator and the discriminators (port of
vm_asr_tpu/train/states.py).

The JAX package's states are immutable pytrees of params and optimizer
state; here a state holds the module (its parameters, and for a
discriminator the spectral-norm buffers ``u``/``sigma`` that flax keeps in
``batch_stats``), the optimizer with its schedule, and the step count, and
``apply_gradients`` updates them in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from .optim import Optimizer


@dataclass
class GenState:
    module: torch.nn.Module
    optimizer: Optimizer
    step: int = 0

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return self.optimizer.params

    def apply_gradients(self, grads) -> "GenState":
        self.optimizer.apply(grads)
        self.step += 1
        return self


@dataclass
class DiscState(GenState):
    """A discriminator's state. Its flax ``batch_stats`` are the module's
    spectral-norm buffers, which its forward updates with
    ``update_stats=True``."""
