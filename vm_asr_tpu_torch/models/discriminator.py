"""Multi-period discriminator with flax-semantics spectral norm (port of
vm_asr_tpu/models/discriminator.py:92-209; reference
model/discriminator.py:21-147).

The reference's norm flag is inverted (``weight_norm if use_spectral_norm
else spectral_norm``, default False), so its models train with spectral norm;
the JAX package keeps that, and so does this port: every conv is a
``SpectralNormConv2d``.

``SpectralNormConv2d`` follows flax's ``nn.SpectralNorm`` (flax 0.12.3,
``_spectral_normalize``), not ``torch.nn.utils.parametrizations.spectral_norm``:

- the kernel is taken in flax's layout, (kh, kw, I, O) flattened to
  (kh·kw·I, O), and the power-iteration vector ``u`` is (1, O), so ``u``
  carries over from a flax ``batch_stats`` tree as it is;
- every call runs one power-iteration step, also with ``update_stats=False``;
  ``u`` and ``sigma`` are stored only when ``update_stats`` is True;
- the gradient flows through sigma; u and v are constants (stop-gradient).

Convolutions run NCHW: the period fold of a (B, T) waveform is
(B, 1, T/p, p), where the JAX package's NHWC fold is (B, T/p, p, 1); feature
maps come out NCHW. Parameters are float32 and each conv computes in
``compute_dtype``, as flax's ``dtype=`` does.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import uniform_


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum() + eps)


class SpectralNormConv2d(nn.Module):
    """flax ``SpectralNorm(Conv(dtype=compute_dtype))`` on NCHW input, one
    power-iteration step per call. Buffers ``u`` (1, out) and ``sigma`` ()
    are the flax ``batch_stats``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 stride: Tuple[int, int], padding: Tuple[int, int], *,
                 compute_dtype: torch.dtype = torch.float32, eps: float = 1e-12):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.register_buffer("u", torch.empty(1, out_channels))
        self.register_buffer("sigma", torch.ones(()))
        self.stride, self.padding = stride, padding
        self.compute_dtype = compute_dtype
        self.eps = eps

    def init_from(self, generator: torch.Generator) -> None:
        """torch's conv default, U(±1/sqrt(fan_in)), for kernel and bias (the
        JAX package's torch_linear_init / torch_bias_init); u ~ N(0, 1)."""
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)
        with torch.no_grad():
            self.u.copy_(torch.randn(self.u.shape, generator=generator))
            self.sigma.fill_(1.0)

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        out_ch, in_ch, kh, kw = self.weight.shape
        w = self.weight.permute(2, 3, 1, 0).reshape(-1, out_ch)  # flax (kh·kw·I, O)
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.T, self.eps)
            u = _l2_normalize(v @ w, self.eps)
        sigma = (v @ w @ u.T)[0, 0]
        w = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w.reshape(kh, kw, in_ch, out_ch).permute(3, 2, 0, 1)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.normalized_weight(update_stats)
        return F.conv2d(x.to(dt), w.to(dt), self.bias.to(dt), self.stride, self.padding)


class PeriodDiscriminator(nn.Module):
    """Conv2d stack over the period-folded waveform: five strided convs with
    exact GELU, then conv_post. Returns (scores (B, -1), feature maps)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 hidden: int = 32, *, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        widths = [hidden, hidden * 4, hidden * 16, hidden * 32, hidden * 32]
        strides = [stride] * 4 + [1]
        ins = [1] + widths[:-1]
        self.convs = nn.ModuleList(
            SpectralNormConv2d(i, o, (kernel_size, 1), (s, 1), (pad, 0),
                               compute_dtype=compute_dtype)
            for i, o, s in zip(ins, widths, strides)
        )
        self.conv_post = SpectralNormConv2d(widths[-1], 1, (3, 1), (1, 1), (1, 0),
                                            compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        b, t = x.shape[0], x.shape[-1]
        x = x.reshape(b, t)  # accept (B, T) or (B, 1, T)
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
            t += n_pad
        x = x.reshape(b, 1, t // self.period, self.period)
        feature_map: List[torch.Tensor] = []
        for conv in self.convs:
            x = F.gelu(conv(x, update_stats))
            feature_map.append(x)
        x = self.conv_post(x, update_stats)
        feature_map.append(x)
        return x.reshape(b, -1), feature_map


def _real_fake_pass(disc, y, y_hat, update_stats):
    """One sub-discriminator on the (real, fake) pair, as the JAX package
    runs it: with frozen stats (the generator-loss pass) real and fake go
    through as one concatenated batch; with ``update_stats`` as two calls,
    real then fake, each advancing the power iteration once."""
    if y_hat is not None and not update_stats:
        b = y.shape[0]
        s_b, f_b = disc(torch.cat([y, y_hat], dim=0), update_stats=False)
        return s_b[:b], [f[:b] for f in f_b], s_b[b:], [f[b:] for f in f_b]
    s_r, f_r = disc(y, update_stats=update_stats)
    if y_hat is None:
        return s_r, f_r, 0, 0
    s_g, f_g = disc(y_hat, update_stats=update_stats)
    return s_r, f_r, s_g, f_g


class MultiPeriodDiscriminator(nn.Module):
    """One PeriodDiscriminator per period (reference discriminator.py:121-147).

    forward(y, y_hat, update_stats) → (real scores, fake scores, real feature
    maps, fake feature maps), one entry per period."""

    def __init__(self, hidden: int = 32, periods: Sequence[int] = (2, 3, 5, 7, 11), *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.discriminators = nn.ModuleList(
            PeriodDiscriminator(p, hidden=hidden, compute_dtype=compute_dtype)
            for p in periods
        )

    def forward(self, y: torch.Tensor, y_hat: Optional[torch.Tensor],
                update_stats: bool = False):
        y_real, y_gen, fmap_real, fmap_gen = [], [], [], []
        for disc in self.discriminators:
            s_r, f_r, s_g, f_g = _real_fake_pass(disc, y, y_hat, update_stats)
            y_real.append(s_r)
            fmap_real.append(f_r)
            y_gen.append(s_g)
            fmap_gen.append(f_g)
        return y_real, y_gen, fmap_real, fmap_gen
