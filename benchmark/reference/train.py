"""The published GAN training step, plainly (VM-ASR trainer/trainer.py):

1. the generator's forward in training mode (DropPath masks from ``masks``:
   a ``torch.Generator`` to draw them from, or the masks the program drew,
   ``Recorded``);
2. its loss: the multi-resolution STFT loss (SC 0.5, magnitude 0.5), and
   for each discriminator LSGAN's adversarial term and λ · feature matching,
   with the discriminator on real and fake as one batch, statistics frozen;
3. its gradient and one AdamW update;
4. the discriminator's LSGAN loss on real and on the fake from before the
   update, two calls that each advance the power iteration, its gradient
   and one AdamW update.

AdamW is torch's (eps outside the square root, bias correction), and the
learning rate follows the published warm-up then cosine schedule, indexed
by the number of updates made before this one.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from . import losses as L
from .generator import Generator
from .mpd import MPD
from .precision import Products


def learning_rate(cfg: dict, steps_per_epoch: int, count: int) -> float:
    """TRAIN.LR_SCHEDULER "cosine": MIN_LR → BASE_LR linearly over the
    warm-up epochs, then a cosine from BASE_LR down to MIN_LR."""
    t = cfg["TRAIN"]
    if t["LR_SCHEDULER"]["NAME"] != "cosine":
        raise NotImplementedError("the reference knows the cosine schedule only")
    warm = t["WARMUP_EPOCHS"] * steps_per_epoch
    total = t["EPOCHS"] * steps_per_epoch
    if count < warm:
        return (t["MIN_LR"] - t["BASE_LR"]) * (1 - count / max(warm, 1)) + t["BASE_LR"]
    steps = max(total - warm, 1)
    cos = 0.5 * (1 + math.cos(math.pi * min(count - warm, steps) / steps))
    alpha = t["MIN_LR"] / t["BASE_LR"]
    return t["BASE_LR"] * ((1 - alpha) * cos + alpha)


class AdamW:
    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor], steps_per_epoch: int):
        t = cfg["TRAIN"]
        if t["OPTIMIZER"]["NAME"].lower() != "adamw" or t["WEIGHT_DECAY"] != 0:
            raise NotImplementedError("the reference's AdamW has no weight decay")
        if t["ACCUMULATION_STEPS"] != 1:
            raise NotImplementedError("the reference does not accumulate gradients")
        self.cfg, self.spe = cfg, steps_per_epoch
        self.params = params
        self.b1, self.b2 = t["OPTIMIZER"]["BETAS"]
        self.eps = t["OPTIMIZER"]["EPS"]
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        lr = learning_rate(self.cfg, self.spe, self.count)
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def _check(cfg: dict) -> None:
    t, adv = cfg["TRAIN"], cfg["TRAIN"]["ADVERSARIAL"]
    if list(t["LOSSES"]["GEN"]) != ["multi_resolution_stft"] or not adv["ENABLE"] \
            or [d for d in adv["DISCRIMINATORS"] if d] != ["mpd"] \
            or adv["GAN_LOSS_TYPE"] != "lsgan" or adv.get("DISC_INPUT_GAIN", 1.0) != 1.0 \
            or adv["ONLY_FEATURE_LOSS"] or adv["ONLY_ADVERSARIAL_LOSS"] \
            or adv["STFT_LOSS"]["EMPHASIZE_HIGH_FREQ"]:
        raise NotImplementedError("the reference step is the MPD-only LSGAN step with the "
                                  "multi-resolution STFT loss")


class Recorded:
    """The DropPath masks of one step as the program drew them: for each VSS
    block (its name in the state dict), the per-row keep masks of its calls
    in order. The reference's calls take them in the same order; ``rows``
    cuts each to the rows the reference is given. A call with no mask of
    its rows recorded keeps every row and counts in ``misses``."""

    def __init__(self, by_block: Dict[str, List[torch.Tensor]], rows=None):
        self.by_block, self.rows = by_block, rows
        self.used: Dict[str, int] = defaultdict(int)
        self.misses = 0

    def __call__(self, block: str, x: torch.Tensor, keep: float) -> torch.Tensor:
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        i = self.used[block]
        self.used[block] += 1
        seq = self.by_block.get(block, [])
        mask: Optional[torch.Tensor] = seq[i] if i < len(seq) else None
        if mask is not None and self.rows is not None:
            mask = mask[self.rows]
        if mask is None or mask.numel() != x.shape[0]:
            self.misses += 1
            return torch.ones(shape, dtype=torch.bool, device=x.device)
        return mask.to(x.device).reshape(shape)


class Step:
    """The reference's generator, MPD and both optimizers, from a state dict
    of each."""

    def __init__(self, cfg: dict, gen_state, mpd_state, steps_per_epoch: int,
                 products: Products, device):
        _check(cfg)
        self.cfg = cfg
        self.gen = Generator(cfg, products).to(device)
        self.gen.load_state_dict(gen_state)
        self.gen.train()
        self.mpd = MPD(cfg, products).to(device)
        self.mpd.load_state_dict(mpd_state)
        self.gen_params = dict(self.gen.named_parameters())
        self.mpd_params = dict(self.mpd.named_parameters())
        self.gen_opt = AdamW(cfg, self.gen_params, steps_per_epoch)
        self.mpd_opt = AdamW(cfg, self.mpd_params, steps_per_epoch)

    def __call__(self, x, y, masks) -> List[float]:
        """One step on (B, 1, T) input ``x`` and target ``y``; returns the
        generator's and the discriminator's loss."""
        adv = self.cfg["TRAIN"]["ADVERSARIAL"]
        sc = adv["STFT_LOSS"]
        out = self.gen(x, masks)
        _, fake_scores, f_real, f_fake = self.mpd(y, out, update_stats=False)
        total = L.multi_resolution_stft(out[:, 0], y[:, 0], sc["SC_FACTOR"], sc["MAG_FACTOR"]) \
            + L.gen_adv_loss(fake_scores) \
            + adv["FEATURE_LOSS_LAMBDA"] * L.feature_loss(f_real, f_fake)
        grads = torch.autograd.grad(total, list(self.gen_params.values()), allow_unused=True,
                                    materialize_grads=True)
        self.gen_opt.step(dict(zip(self.gen_params, grads)))
        real_scores, fake_scores, _, _ = self.mpd(y, out.detach(), update_stats=True)
        d_loss = L.disc_loss(real_scores, fake_scores)
        grads = torch.autograd.grad(d_loss, list(self.mpd_params.values()),
                                    allow_unused=True, materialize_grads=True)
        self.mpd_opt.step(dict(zip(self.mpd_params, grads)))
        return [float(total.detach()), float(d_loss.detach())]
