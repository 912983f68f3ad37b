"""Plain reference of the multi-period discriminator (HiFi-GAN; VM-ASR
model/discriminator.py, whose inverted flag makes every conv spectral-normed).

Each period p folds the waveform to (B, 1, T/p, p) after a reflect pad, and
runs five strided (5, 1) convs with exact GELU and a (3, 1) conv_post.
Spectral norm follows flax's ``SpectralNorm``, as the published training
does: the kernel in (kh, kw, I, O) order flattened to (·, O), one power
iteration a call from the stored ``u`` (1, O), the weight divided by
sigma = v·W·uᵀ with u and v held constant under autograd, and ``u`` and
``sigma`` stored only when the call updates the statistics.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import Products


def _l2n(x, eps=1e-12):
    return x * torch.rsqrt(x.square().sum() + eps)


class SNConv2d(nn.Module):
    def __init__(self, products, d_in, d_out, k, stride, pad):
        super().__init__()
        self.products = products
        self.weight = nn.Parameter(torch.empty(d_out, d_in, k, 1))
        self.bias = nn.Parameter(torch.empty(d_out))
        self.register_buffer("u", torch.empty(1, d_out))
        self.register_buffer("sigma", torch.ones(()))
        self.stride, self.pad = (stride, 1), (pad, 0)

    def forward(self, x, update_stats):
        flax = self.weight.permute(2, 3, 1, 0)
        w = flax.reshape(-1, flax.shape[-1])
        with torch.no_grad():
            v = _l2n(self.u @ w.T)
            u = _l2n(v @ w)
        sigma = (v @ w @ u.T)[0, 0]
        w = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        w = w.reshape(flax.shape).permute(3, 2, 0, 1)
        return self.products.conv2d(x, w, self.bias, self.stride, self.pad)


class PeriodDiscriminator(nn.Module):
    def __init__(self, products, period, hidden):
        super().__init__()
        self.period = period
        widths = [hidden, hidden * 4, hidden * 16, hidden * 32, hidden * 32]
        ins = [1] + widths[:-1]
        strides = [3, 3, 3, 3, 1]
        self.convs = nn.ModuleList(SNConv2d(products, i, o, 5, s, 2)
                                   for i, o, s in zip(ins, widths, strides))
        self.conv_post = SNConv2d(products, widths[-1], 1, 3, 1, 1)

    def forward(self, x, update_stats):
        b, t = x.shape[0], x.shape[-1]
        x = x.reshape(b, t)
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
            t += n_pad
        x = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.gelu(conv(x, update_stats))
            fmap.append(x)
        x = self.conv_post(x, update_stats)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class MPD(nn.Module):
    """forward(y, y_hat, update_stats) → (real scores, fake scores, real
    feature maps, fake feature maps), one entry a period. With frozen
    statistics real and fake go through as one batch; with updates, as two
    calls, real then fake, each advancing the power iteration."""

    def __init__(self, cfg: dict, products: Products):
        super().__init__()
        adv = cfg["TRAIN"]["ADVERSARIAL"]
        if adv.get("MPD_STACKED", False):
            raise NotImplementedError("the reference MPD runs its periods one by one")
        self.discriminators = nn.ModuleList(
            PeriodDiscriminator(products, p, adv["MPD_HIDDEN"])
            for p in adv.get("MPD_PERIODS", [2, 3, 5, 7, 11]))

    def forward(self, y, y_hat, update_stats=False):
        out = ([], [], [], [])
        for d in self.discriminators:
            if not update_stats:
                b = y.shape[0]
                s, f = d(torch.cat([y, y_hat]), False)
                parts = (s[:b], s[b:], [x[:b] for x in f], [x[b:] for x in f])
            else:
                s_r, f_r = d(y, True)
                s_g, f_g = d(y_hat, True)
                parts = (s_r, s_g, f_r, f_g)
            for acc, part in zip(out, parts):
                acc.append(part)
        return out
