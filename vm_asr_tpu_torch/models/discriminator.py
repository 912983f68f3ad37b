"""The HiFi-GAN-style discriminators with flax-semantics spectral norm (port
of vm_asr_tpu/models/discriminator.py; reference model/discriminator.py):

- MultiPeriodDiscriminator: one Conv2d stack per period over the
  period-folded waveform (periods 2, 3, 5, 7, 11);
- StackedMultiPeriodDiscriminator: the same module, with the periods of a
  group run as one grouped conv per layer on padded lanes (MPD_STACKED);
- MultiScaleDiscriminator: three Conv1d stacks over the waveform average-
  pooled 1, 2 and 4 times (the MSD).

The reference's norm flag is inverted (``weight_norm if use_spectral_norm
else spectral_norm``, default False), so its models train with spectral norm;
the JAX package keeps that, and so does this port: every conv is a
spectral-normed conv.

``SpectralNormConv2d`` and ``SpectralNormConv1d`` follow flax's
``nn.SpectralNorm`` (flax 0.12.3, ``_spectral_normalize``), not
``torch.nn.utils.parametrizations.spectral_norm``:

- the kernel is taken in flax's layout, (kh, kw, I/g, O) or (k, I/g, O)
  flattened to (·, O), and the power-iteration vector ``u`` is (1, O), so
  ``u`` carries over from a flax ``batch_stats`` tree as it is;
- every call runs one power-iteration step, also with ``update_stats=False``;
  ``u`` and ``sigma`` are stored only when ``update_stats`` is True;
- the gradient flows through sigma; u and v are constants (stop-gradient).

Convolutions run channels-first: the period fold of a (B, T) waveform is
(B, 1, T/p, p), where the JAX package's NHWC fold is (B, T/p, p, 1), and the
MSD runs (B, C, T) where the JAX package runs (B, T, C); feature maps come out
channels-first. Parameters are float32 and each conv computes in
``compute_dtype``, as flax's ``dtype=`` does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import uniform_


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum() + eps)


class _SpectralNormConv(nn.Module):
    """flax ``SpectralNorm(Conv(dtype=compute_dtype))`` over a torch conv
    weight (out, in/groups, *kernel), one power-iteration step per call.
    Buffers ``u`` (1, out) and ``sigma`` () are the flax ``batch_stats``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, ...],
                 stride, padding, groups: int = 1, *,
                 compute_dtype: torch.dtype = torch.float32, eps: float = 1e-12):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups,
                                               *kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.register_buffer("u", torch.empty(1, out_channels))
        self.register_buffer("sigma", torch.ones(()))
        self.stride, self.padding, self.groups = stride, padding, groups
        self.compute_dtype = compute_dtype
        self.eps = eps

    def init_from(self, generator: torch.Generator) -> None:
        """torch's conv default, U(±1/sqrt(fan_in)), for kernel and bias (the
        JAX package's torch_linear_init / torch_bias_init, fan_in = (in/g)·k);
        u ~ N(0, 1)."""
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)
        with torch.no_grad():
            self.u.copy_(torch.randn(self.u.shape, generator=generator))
            self.sigma.fill_(1.0)

    def _flax_order(self):
        """The permutation of the weight's axes into flax's (*kernel, I, O)."""
        return tuple(range(2, self.weight.dim())) + (1, 0)

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        order = self._flax_order()
        flax = self.weight.permute(*order)
        w = flax.reshape(-1, flax.shape[-1])  # flax (k·I, O)
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.T, self.eps)
            u = _l2_normalize(v @ w, self.eps)
        sigma = (v @ w @ u.T)[0, 0]
        w = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w.reshape(flax.shape).permute(*[order.index(i) for i in range(len(order))])

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.normalized_weight(update_stats)
        return self._conv(x.to(dt), w.to(dt), self.bias.to(dt), self.stride, self.padding,
                          groups=self.groups)


class SpectralNormConv2d(_SpectralNormConv):
    """A spectral-normed ``Conv2d`` on NCHW input."""

    _conv = staticmethod(F.conv2d)

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 stride: Tuple[int, int], padding: Tuple[int, int], **kwargs):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, **kwargs)


class SpectralNormConv1d(_SpectralNormConv):
    """A spectral-normed grouped ``Conv1d`` on (B, C, T) input. The JAX
    package writes the grouped conv as ``feature_group_count`` dense convs
    (``GroupedConv1d``) to dodge a GSPMD gradient bug that has no
    counterpart here; its kernel (k, I/g, O) is this weight (O, I/g, k)."""

    _conv = staticmethod(F.conv1d)

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 padding: int, groups: int = 1, **kwargs):
        super().__init__(in_channels, out_channels, (kernel_size,), stride, padding, groups,
                         **kwargs)


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


# ---------------------------------------------------------------------------
# Stacked MPD execution (JAX package: models/discriminator.py:213-522)
#
# The periods fold to images of different shapes, so the lanes of a group
# are padded to the group's (max ceil(T/p), max p) and run as one grouped
# conv per layer (groups = lanes); after every conv a static mask re-zeros
# the padding, so the next conv sees the zeros its own padding would give
# and each lane's valid region is the unstacked stack's; the per-period
# scores and feature maps are sliced back out before the losses. The
# parameters stay the unstacked MPD's (``discriminators.i.*``): each pass
# stacks a group's normalised weights, so checkpoints, optimizer state and
# resumes are the same with the option on or off.


def _conv_out_len(h: int, k: int, s: int, pad: int) -> int:
    return (h + 2 * pad - k) // s + 1


def _fold_period(x: torch.Tensor, period: int) -> torch.Tensor:
    """(B, T) → (B, ceil(T/p), p) with the reference's reflect pad
    (discriminator.py:62-66)."""
    b, t = x.shape
    if t % period:
        x = F.pad(x[:, None], (0, period - t % period), mode="reflect")[:, 0]
    return x.reshape(b, -1, period)


def _mpd_stack_geometry(t: int, group: Sequence[int], kernel_size: int = 5, stride: int = 3):
    """Static shapes of one stacked group for T = ``t``: per lane the valid
    heights [h_in, after conv 0, ..., after conv_post], the padded heights
    H̄ (the lanes' largest) at each of those points, and the padded width W̄
    (the largest period)."""
    pad = (kernel_size - 1) // 2
    specs = [(kernel_size, stride, pad)] * 4 + [(kernel_size, 1, pad), (3, 1, 1)]
    lane_heights = []
    for p in group:
        hs = [-(-t // p)]
        for k, s_, pd in specs:
            hs.append(_conv_out_len(hs[-1], k, s_, pd))
        lane_heights.append(hs)
    h_bar = [max(hs[i] for hs in lane_heights) for i in range(len(specs) + 1)]
    return lane_heights, h_bar, max(group)


def _group_masks(t: int, group: Sequence[int], kernel_size: int, stride: int,
                 dtype: torch.dtype, device) -> List[torch.Tensor]:
    """Per conv layer, (1, lanes, 1, H̄_l, W̄): 1 on each lane's valid rows
    and columns, 0 on its padding."""
    lane_heights, h_bar, w_bar = _mpd_stack_geometry(t, group, kernel_size, stride)
    masks = []
    for li in range(len(h_bar) - 1):
        m = torch.zeros(1, len(group), 1, h_bar[li + 1], w_bar, dtype=dtype)
        for lane, p in enumerate(group):
            m[0, lane, 0, :lane_heights[lane][li + 1], :p] = 1
        masks.append(m.to(device))
    return masks


def _stacked_weights(convs: Sequence[_SpectralNormConv], update_stats: bool):
    """The lanes' spectral-normed weights as one grouped conv's, (lanes·O,
    I, k, 1), and their biases, (lanes·O,): one power-iteration step per
    lane, batched, each as ``SpectralNormConv2d.normalized_weight`` takes it;
    with ``update_stats`` each lane's ``u`` and ``sigma`` are stored."""
    weight = torch.stack([c.weight for c in convs])            # (G, O, I, k, 1)
    flax = weight.permute(0, 3, 4, 2, 1)                       # (G, k, 1, I, O)
    w = flax.reshape(len(convs), -1, flax.shape[-1])           # (G, k·I, O)
    eps = convs[0].eps
    with torch.no_grad():
        u0 = torch.stack([c.u for c in convs])                 # (G, 1, O)
        v = u0 @ w.transpose(1, 2)
        v = v * torch.rsqrt(v.square().sum((1, 2), keepdim=True) + eps)
        u = v @ w
        u = u * torch.rsqrt(u.square().sum((1, 2), keepdim=True) + eps)
    sigma = (v @ w @ u.transpose(1, 2))[:, 0, 0]
    w = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))[:, None, None]
    if update_stats:
        with torch.no_grad():
            for i, c in enumerate(convs):
                c.u.copy_(u[i])
                c.sigma.copy_(sigma[i])
    w = w.reshape(flax.shape).permute(0, 4, 3, 1, 2)           # (G, O, I, k, 1)
    return w.reshape(-1, *w.shape[2:]), torch.cat([c.bias for c in convs])


class StackedMultiPeriodDiscriminator(MultiPeriodDiscriminator):
    """MultiPeriodDiscriminator with each group of periods run as one grouped
    conv per layer (see the note above): the same parameters, state_dict,
    call and return structure, loss-identical. ``groups`` partitions
    ``periods`` in order (MPD_STACK_GROUPS); None, one group of all."""

    def __init__(self, hidden: int = 32, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 groups: Optional[Sequence[Sequence[int]]] = None, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(hidden, periods, compute_dtype=compute_dtype)
        self.periods = tuple(periods)
        self.groups = _mpd_groups(self.periods, groups)
        self.compute_dtype = compute_dtype
        self._masks: Dict[tuple, List[torch.Tensor]] = {}

    def _masks_for(self, t: int, group, device) -> List[torch.Tensor]:
        key = (t, group, str(device))
        if key not in self._masks:
            first = self.discriminators[0]
            k, s_ = first.convs[0].weight.shape[2], first.convs[0].stride[0]
            self._masks[key] = _group_masks(t, group, k, s_, self.compute_dtype, device)
        return self._masks[key]

    def _run_group(self, lanes, x, masks, update_stats: bool):
        """The group's stack on its folded lanes x (B, G, H̄, W̄): (score,
        feature maps), each (B, G, C, H̄_l, W̄)."""
        b, g = x.shape[:2]
        fmaps = []
        for j in range(len(lanes[0].convs) + 1):
            convs = [lane.convs[j] if j < len(lane.convs) else lane.conv_post for lane in lanes]
            w, bias = _stacked_weights(convs, update_stats)
            dt = self.compute_dtype
            x = F.conv2d(x.to(dt), w.to(dt), bias.to(dt), convs[0].stride, convs[0].padding,
                         groups=g)
            # Mask before the GELU: gelu(0) = 0, so the padding stays zeros.
            x = (x.view(b, g, -1, *x.shape[2:]) * masks[j]).view(x.shape)
            if j < len(lanes[0].convs):
                x = F.gelu(x)
            fmaps.append(x)
        return x, fmaps

    def forward(self, y: torch.Tensor, y_hat: Optional[torch.Tensor],
                update_stats: bool = False):
        b = y.shape[0]
        y2 = y.reshape(b, -1)
        t = y2.shape[-1]
        index = {p: i for i, p in enumerate(self.periods)}
        out = {}
        for group in self.groups:
            lanes = [self.discriminators[index[p]] for p in group]
            lane_heights, h_bar, w_bar = _mpd_stack_geometry(
                t, group, lanes[0].convs[0].weight.shape[2], lanes[0].convs[0].stride[0])
            masks = self._masks_for(t, group, y.device)

            def fold_stack(w):
                return torch.stack([F.pad(_fold_period(w, p),
                                          (0, w_bar - p, 0, h_bar[0] - lane_heights[i][0]))
                                    for i, p in enumerate(group)], dim=1)

            def lanes_of(x, fmaps, rows):
                """Per lane: (score (rows, -1), its feature maps, NCHW)."""
                split = lambda v: v.view(v.shape[0], len(group), -1, *v.shape[2:])  # noqa: E731
                x, fmaps = split(x)[rows], [split(f)[rows] for f in fmaps]
                return [(x[:, i, 0, :hs[-1], :p].reshape(x.shape[0], -1),
                         [f[:, i, :, :hs[li + 1], :p] for li, f in enumerate(fmaps)])
                        for i, (p, hs) in enumerate(zip(group, lane_heights))]

            # The real/fake policy of _real_fake_pass: one pass on both with
            # frozen stats, two passes (real, then fake) with update_stats.
            if y_hat is not None and not update_stats:
                both = self._run_group(lanes, fold_stack(torch.cat([y2, y_hat.reshape(b, -1)])),
                                       masks, False)
                real, fake = lanes_of(*both, slice(None, b)), lanes_of(*both, slice(b, None))
            else:
                real = lanes_of(*self._run_group(lanes, fold_stack(y2), masks, update_stats),
                                slice(None))
                fake = None if y_hat is None else lanes_of(*self._run_group(
                    lanes, fold_stack(y_hat.reshape(b, -1)), masks, update_stats), slice(None))
            for i, p in enumerate(group):
                out[p] = (real[i], None if fake is None else fake[i])
        y_real, y_gen, fmap_real, fmap_gen = [], [], [], []
        for p in self.periods:
            (s_r, f_r), fake = out[p]
            y_real.append(s_r)
            fmap_real.append(f_r)
            y_gen.append(0 if fake is None else fake[0])
            fmap_gen.append(0 if fake is None else fake[1])
        return y_real, y_gen, fmap_real, fmap_gen


def _mpd_groups(periods: Sequence[int], groups: Optional[Sequence[Sequence[int]]] = None
               ) -> Tuple[Tuple[int, ...], ...]:
    """``groups`` as tuples, checked to partition ``periods`` in order; None
    or empty: one group of all the periods."""
    if not groups:
        return (tuple(periods),)
    groups = tuple(tuple(g) for g in groups)
    if tuple(p for g in groups for p in g) != tuple(periods):
        raise ValueError(f"groups {groups} must partition periods {tuple(periods)} in order")
    return groups


def stack_mpd_state(state: Mapping[str, torch.Tensor], periods: Sequence[int] = (2, 3, 5, 7, 11),
                    groups=None) -> Dict[str, torch.Tensor]:
    """An MPD ``state_dict`` (``discriminators.i.*``, also an optimizer's
    per-parameter state keyed alike) → the stacked layout the JAX package's
    ``StackedMultiPeriodDiscriminator`` keeps (``stack_mpd_params``):
    ``group_g.*``, each tensor the group's lanes stacked on a new axis 0."""
    index = {p: i for i, p in enumerate(periods)}
    out = {}
    for g, group in enumerate(_mpd_groups(periods, groups)):
        first = f"discriminators.{index[group[0]]}."
        for key in (k for k in state if k.startswith(first)):
            rest = key[len(first):]
            out[f"group_{g}.{rest}"] = torch.stack(
                [state[f"discriminators.{index[p]}.{rest}"] for p in group])
    return out


def unstack_mpd_state(state: Mapping[str, torch.Tensor], periods: Sequence[int] = (2, 3, 5, 7, 11),
                      groups=None) -> Dict[str, torch.Tensor]:
    """The inverse of ``stack_mpd_state`` (the JAX ``unstack_mpd_params``):
    a stacked MPD's ``group_g.*`` tensors → ``discriminators.i.*``, the
    layout of the port's ``.pth`` files."""
    index = {p: i for i, p in enumerate(periods)}
    out = {}
    for g, group in enumerate(_mpd_groups(periods, groups)):
        prefix = f"group_{g}."
        for key in (k for k in state if k.startswith(prefix)):
            for lane, p in enumerate(group):
                out[f"discriminators.{index[p]}.{key[len(prefix):]}"] = state[key][lane]
    return out


# ---------------------------------------------------------------------------
# The MSD (reference discriminator.py:174-313)


class ScaleDiscriminator(nn.Module):
    """Conv1d stack (reference discriminator.py:174-271): seven grouped convs
    (kernels 15/41/41/41/41/41/5, strides 1/4/4/4/4/4/1, groups
    1/4/16/16/16/16/1) with exact GELU, then conv_post. Returns (scores
    (B, -1), feature maps (B, C, T'))."""

    def __init__(self, hidden: int = 128, *, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        h = hidden
        # (out, kernel, stride, groups, padding)
        specs = [(h, 15, 1, 1, 7), (h, 41, 4, 4, 20), (h * 2, 41, 4, 16, 20),
                 (h * 4, 41, 4, 16, 20), (h * 8, 41, 4, 16, 20), (h * 8, 41, 4, 16, 20),
                 (h * 8, 5, 1, 1, 2)]
        ins = [1] + [spec[0] for spec in specs[:-1]]
        self.convs = nn.ModuleList(
            SpectralNormConv1d(i, o, k, s_, pad, g, compute_dtype=compute_dtype)
            for i, (o, k, s_, g, pad) in zip(ins, specs))
        self.conv_post = SpectralNormConv1d(h * 8, 1, 3, 1, 1, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        b = x.shape[0]
        x = x.reshape(b, 1, -1)  # accept (B, T) or (B, 1, T)
        feature_map: List[torch.Tensor] = []
        for conv in self.convs:
            x = F.gelu(conv(x, update_stats))
            feature_map.append(x)
        x = self.conv_post(x, update_stats)
        feature_map.append(x)
        return x.reshape(b, -1), feature_map


class MultiScaleDiscriminator(nn.Module):
    """Three ScaleDiscriminators, the waveform average-pooled (4, stride 2,
    pad 2, the padding counted as zeros as flax's avg_pool counts it) before
    the second and the third (reference discriminator.py:274-313).

    forward(y, y_hat, update_stats) → (real scores, fake scores, real feature
    maps, fake feature maps), one entry per scale."""

    def __init__(self, hidden: int = 128, *, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.discriminators = nn.ModuleList(
            ScaleDiscriminator(hidden, compute_dtype=compute_dtype) for _ in range(3))

    def forward(self, y: torch.Tensor, y_hat: Optional[torch.Tensor],
                update_stats: bool = False):
        def pool(v):
            return F.avg_pool1d(v[:, None], 4, 2, padding=2)[:, 0]

        y = y.reshape(y.shape[0], -1)
        y_hat = None if y_hat is None else y_hat.reshape(y_hat.shape[0], -1)
        y_real, y_gen, fmap_real, fmap_gen = [], [], [], []
        for i, disc in enumerate(self.discriminators):
            if i:
                y = pool(y)
                y_hat = None if y_hat is None else pool(y_hat)
            s_r, f_r, s_g, f_g = _real_fake_pass(disc, y, y_hat, update_stats)
            y_real.append(s_r)
            fmap_real.append(f_r)
            y_gen.append(s_g)
            fmap_gen.append(f_g)
        return y_real, y_gen, fmap_real, fmap_gen
