"""The program under test, built by the port's factories from the frozen
configuration and loaded with the state dicts that ``weights.make_state``
drew on the device for the reference's modules, whose keys are the port's."""

from __future__ import annotations

from typing import Dict

import torch

from .reference.generator import Generator
from .reference.mpd import MPD
from .reference.precision import Products
from .weights import make_state


def seeded_states(cfg_dict: dict, seed: int, device, discriminator: bool
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"generator": state dict[, "mpd": state dict]} drawn from ``seed``."""
    with torch.device("meta"):
        models = {"generator": Generator(cfg_dict, Products())}
        if discriminator:
            models["mpd"] = MPD(cfg_dict, Products())
    return {name: make_state(m, seed + i, device) for i, (name, m) in enumerate(models.items())}


def generator(cfg, state: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The port's generator of ``cfg`` from its factory, with ``state``."""
    from vm_asr_tpu_torch.models import get_generator

    model = get_generator(cfg, device=device)
    model.load_state_dict(state)
    return model.eval()


def discriminators(cfg, states: Dict[str, Dict[str, torch.Tensor]], device
                   ) -> Dict[str, torch.nn.Module]:
    """The port's discriminators of ``cfg`` from its factory, with the
    state of each."""
    from vm_asr_tpu_torch.models import get_discriminators

    models = get_discriminators(cfg, device=device)
    for name, model in models.items():
        model.load_state_dict(states[name])
    return models
