"""Plain reference of VM-ASR's generator, ``DualStreamInteractiveMambaUNet``
(ghnmqdtg/VM-ASR model/model.py): the standard U-Net layout, the v2 patch
embedding, the v3 output head, concatenated skips, the "dual" interaction,
and the published quirk that the phase stream runs through the magnitude
decoder (model.py:1148).

    waveform → STFT → (log2 magnitude, phase) without the DC bin
    → per stream: patch embed → encoder stages (VSS blocks, patch merging)
    → after each stage m = m + p, then p = p + m
    → decoder stages (skip joined by concatenation and a 1×1 conv, VSS
      blocks, patch expanding), the same interaction after each
    → v3 head → magnitude + the input magnitude, phase as predicted
    → DC bin back → inverse STFT

Channels last (B, H, W, C), float32 throughout; the products at the
precision of ``Products``. In training mode each DropPath takes its
per-row mask from ``masks(block, x, keep)``, where ``block`` is the VSS
block's name in the state dict: ``Drawn`` draws ``torch.rand((B, 1, 1, 1),
generator=g) < keep`` in forward order (a generator seeded as the port's
draws its masks); the training check hands in the masks the program drew
(``reference.train.Recorded``).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .dsp import spectro2wav, wav2spectro
from .precision import Products
from .scan import selective_scan

_ACT = {"silu": F.silu, "gelu": F.gelu, "relu": F.relu}


class Env:
    """What every module shares: the products' precision and, when set, the
    list that records the scans' shapes."""

    def __init__(self, products: Products):
        self.products = products
        self.scan_record: Optional[List[tuple]] = None


class Linear(nn.Module):
    def __init__(self, env, d_in, d_out, bias=True):
        super().__init__()
        self.env = env
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x):
        return self.env.products.linear(x, self.weight, self.bias)


class Conv1x1(nn.Module):
    """A 1×1 Conv2d weight (out, in, 1, 1) applied to channels-last input."""

    def __init__(self, env, d_in, d_out):
        super().__init__()
        self.env = env
        self.weight = nn.Parameter(torch.empty(d_out, d_in, 1, 1))
        self.bias = nn.Parameter(torch.empty(d_out))

    def forward(self, x):
        return self.env.products.linear(x, self.weight[:, :, 0, 0], self.bias)


class Conv2d(nn.Module):
    """A Conv2d on channels-last input."""

    def __init__(self, env, d_in, d_out, k, stride=1, padding=0, groups=1, bias=True):
        super().__init__()
        self.env = env
        self.weight = nn.Parameter(torch.empty(d_out, d_in // groups, k, k))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x):
        y = self.env.products.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                                     self.stride, self.padding, self.groups)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim):
        super().__init__(dim, eps=1e-5)


class Drawn:
    """DropPath masks drawn from ``g`` in forward order, as the port draws
    them from a generator seeded alike."""

    def __init__(self, g: torch.Generator):
        self.g = g

    def __call__(self, block: str, x: torch.Tensor, keep: float) -> torch.Tensor:
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return torch.rand(shape, generator=self.g, device=x.device) < keep


def drop_path(x, rate: float, training: bool, masks: Optional[Callable], block: str):
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(masks(block, x, keep), x / keep, torch.zeros_like(x))


def cross_scan(x):
    """(B, H, W, C) → (B, H·W, 4, C): rows, columns, and both reversed."""
    b, h, w, c = x.shape
    row = x.reshape(b, h * w, c)
    col = x.transpose(1, 2).reshape(b, h * w, c)
    return torch.stack([row, col, row.flip(1), col.flip(1)], dim=2)


def cross_merge(ys, h, w):
    """The adjoint of ``cross_scan``: each direction back to row order, summed."""
    b, l, _, c = ys.shape
    fwd = ys[:, :, 0] + ys[:, :, 2].flip(1)
    swp = (ys[:, :, 1] + ys[:, :, 3].flip(1)).reshape(b, w, h, c).transpose(1, 2)
    return fwd + swp.reshape(b, l, c)


class SS2D(nn.Module):
    def __init__(self, env, d_model, d_state, ssm_ratio, dt_rank, act, d_conv, conv_bias):
        super().__init__()
        self.env = env
        d = int(ssm_ratio * d_model)
        r = int(np.ceil(d_model / 16)) if dt_rank == "auto" else int(dt_rank)
        self.d, self.r, self.n, self.k = d, r, d_state, 4
        self.act = _ACT[act]
        self.in_proj = Linear(env, d_model, 2 * d, bias=False)
        self.conv2d = Conv2d(env, d, d, d_conv, padding=(d_conv - 1) // 2, groups=d,
                             bias=conv_bias)
        self.x_proj_weight = nn.Parameter(torch.empty(4, r + 2 * d_state, d))
        self.dt_projs_weight = nn.Parameter(torch.empty(4, d, r))
        self.dt_projs_bias = nn.Parameter(torch.empty(4, d))
        self.A_logs = nn.Parameter(torch.empty(4 * d, d_state))
        self.Ds = nn.Parameter(torch.empty(4 * d))
        self.out_norm = LayerNorm(d)
        self.out_proj = Linear(env, d, d_model, bias=False)

    def forward(self, x):
        b, h, w, _ = x.shape
        k, d, n, r = self.k, self.d, self.n, self.r
        prod = self.env.products
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        xs = cross_scan(self.act(self.conv2d(xs)))
        x_dbl = prod.einsum("blkd,kcd->blkc", xs, self.x_proj_weight)
        dts, bs, cs = torch.split(x_dbl, [r, n, n], dim=-1)
        dts = prod.einsum("blkr,kdr->blkd", dts, self.dt_projs_weight)
        y = selective_scan(xs, dts, -torch.exp(self.A_logs).reshape(k, d, n), bs, cs,
                           self.Ds.reshape(k, d), self.dt_projs_bias,
                           record=self.env.scan_record)
        y = self.out_norm(cross_merge(y, h, w)).reshape(b, h, w, d)
        return self.out_proj(y * self.act(z))


class Mlp(nn.Module):
    def __init__(self, env, dim, hidden, act):
        super().__init__()
        self.fc1 = Linear(env, dim, hidden)
        self.fc2 = Linear(env, hidden, dim)
        self.act = _ACT[act]

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class VSSBlock(nn.Module):
    """x + DropPath(SS2D(LN(x))), then x + DropPath(MLP(LN(x)))."""

    def __init__(self, env, dim, rate, use_norm, v):
        super().__init__()
        self.rate = float(rate)
        self.norm = LayerNorm(dim) if use_norm else nn.Identity()
        self.op = SS2D(env, dim, v["SSM_D_STATE"], v["SSM_RATIO"], v["SSM_DT_RANK"],
                       v["SSM_ACT_LAYER"], v["SSM_CONV"], v["SSM_CONV_BIAS"])
        self.norm2 = LayerNorm(dim) if use_norm else nn.Identity()
        self.mlp = Mlp(env, dim, int(dim * v["MLP_RATIO"]), v["MLP_ACT_LAYER"])
        self.name = ""  # the block's name in the generator, set by Generator

    def forward(self, x, g):
        x = x + drop_path(self.op(self.norm(x)), self.rate, self.training, g, self.name)
        return x + drop_path(self.mlp(self.norm2(x)), self.rate, self.training, g, self.name)


class PatchMerging(nn.Module):
    def __init__(self, env, dim, out_dim):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(env, 4 * dim, out_dim, bias=False)

    def forward(self, x):
        h, w = x.shape[1], x.shape[2]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        parts = [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]]
        return self.reduction(self.norm(torch.cat(parts, dim=-1)))


class PatchExpanding(nn.Module):
    def __init__(self, env, dim, use_norm):
        super().__init__()
        self.expand = Linear(env, dim, 2 * dim, bias=False)
        self.norm = LayerNorm(dim // 2) if use_norm else None

    def forward(self, x):
        b, h, w, c = x.shape
        x = self.expand(x).reshape(b, h, w, 2, 2, c // 2).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, 2 * h, 2 * w, c // 2)
        return x if self.norm is None else self.norm(x)


class VSSLayer(nn.Module):
    """[1×1 conv of a concatenated skip] → VSS blocks → [merge or expand]."""

    def __init__(self, env, dim, rates, v, use_norm=True, sampler=None, concat_skip=False):
        super().__init__()
        self.skip_handler = nn.Sequential(nn.Identity(), Conv1x1(env, 2 * dim, dim),
                                          nn.Identity()) if concat_skip else None
        self.blocks = nn.ModuleList(VSSBlock(env, dim, r, use_norm, v) for r in rates)
        if sampler is None:
            self.sampler = None
        elif sampler[0] == "merge":
            self.sampler = PatchMerging(env, dim, sampler[1])
        else:
            self.sampler = PatchExpanding(env, dim, sampler[1])

    def forward(self, x, g):
        if self.skip_handler is not None:
            x = self.skip_handler[1](x)
        for block in self.blocks:
            x = block(x, g)
        return x if self.sampler is None else self.sampler(x)


class PatchEmbed(nn.Sequential):
    """v2: conv 3×3/2 → LN → GELU → conv 3×3/2 → LN, in slots 0, 2, 5, 7."""

    def __init__(self, env, dim):
        super().__init__(Conv2d(env, 1, dim // 2, 3, 2, 1), nn.Identity(), LayerNorm(dim // 2),
                         nn.Identity(), nn.Identity(), Conv2d(env, dim // 2, dim, 3, 2, 1),
                         nn.Identity(), LayerNorm(dim))

    def forward(self, x):
        return self[7](self[5](F.gelu(self[2](self[0](x)))))


class HeadV3(nn.Sequential):
    """VSS(dim0, no norm, skip, expand) → VSS(dim0/2, expand) → 1×1 conv →
    VSS(1, no norm), in slots 0, 1, 3, 5."""

    def __init__(self, env, dim0, rates, v):
        super().__init__(
            VSSLayer(env, dim0, rates, v, use_norm=False, sampler=("expand", True),
                     concat_skip=True),
            VSSLayer(env, dim0 // 2, rates, v, sampler=("expand", True)),
            nn.Identity(), Conv1x1(env, dim0 // 4, 1), nn.Identity(),
            VSSLayer(env, 1, rates, v, use_norm=False))

    def forward(self, x, g):
        return self[5](self[3](self[1](self[0](x, g), g)), g)


def _check(cfg: dict) -> None:
    v = cfg["MODEL"]["VSSM"]
    want = dict(INTERACT="dual", CONCAT_SKIP=True, PATCHEMBED="v2", OUTPUT="v3",
                PATCH_SIZE=4, PATCH_NORM=True, GMLP=False, IN_CHANS=1,
                SSM_DROP_RATE=0.0, MLP_DROP_RATE=0.0, USE_CHECKPOINT=False)
    bad = {k: v.get(k) for k, x in want.items() if v.get(k, x) != x}
    if cfg["MODEL"]["NAME"] != "DualStreamInteractiveMambaUNet" or not isinstance(
            v["DIMS"], int) or v.get("PHASE_DECODER_FIX", False) or bad:
        raise NotImplementedError(f"the reference generator does not cover {bad or cfg['MODEL']}")
    if cfg["DATA"]["STFT"]["SCALE"] != "log2":
        raise NotImplementedError("the reference generator takes log2 magnitudes only")
    # Low-frequency replacement in the published ("torch") mode leaves a
    # (B, 1, T) input as it is: nothing to do.
    if cfg["TRAIN"]["LOW_FREQ_REPLACEMENT"] and cfg["TRAIN"].get("LFR_MODE", "torch") != "torch":
        raise NotImplementedError("the reference generator has no fixed low-frequency replacement")


class Generator(nn.Module):
    """The dual-stream generator of a configuration (the program's
    configuration dict); its state dict keys are the program's."""

    def __init__(self, cfg: dict, products: Products):
        super().__init__()
        _check(cfg)
        v = cfg["MODEL"]["VSSM"]
        stft = cfg["DATA"]["STFT"]
        self.n_fft, self.hop, self.win = stft["N_FFT"], stft["HOP_LENGTH"], stft["WIN_LENGTH"]
        self.env = Env(products)
        depths = list(v["DEPTHS"])
        n = len(depths)
        dims = [v["DIMS"] * 2 ** i for i in range(n)]
        dpr = list(np.linspace(0.0, v["DROP_PATH_RATE"], sum(depths)))

        def rates(lo, hi):
            return dpr[sum(depths[:lo]):sum(depths[:hi])]

        for s in ("mag", "phase"):
            self.add_module(f"patch_embed_{s}", PatchEmbed(self.env, dims[0]))
            self.add_module(f"layers_encoder_{s}", nn.ModuleList(
                VSSLayer(self.env, dims[i], rates(i, i + 1), v,
                         sampler=("merge", dims[i + 1]) if i < n - 1 else None)
                for i in range(n)))
            self.add_module(f"output_layer_{s}", HeadV3(self.env, dims[0], dpr[-1:], v))
        # Decoder i_layer = n .. 1; the first is the empty pass-through stage.
        self.layers_decoder_mag = nn.ModuleList(
            VSSLayer(self.env, dims[i] if i < n - 1 else dims[n - 1], rates(i, i + 1), v,
                     sampler=("expand", True) if i < n else None, concat_skip=i < n)
            for i in range(n, 0, -1))
        self.n = n
        for name, m in self.named_modules():
            if isinstance(m, VSSBlock):
                m.name = name

    def block_names(self) -> List[str]:
        return [m.name for m in self.modules() if isinstance(m, VSSBlock)]

    def network(self, mag, phase, g=None):
        """(B, F, T) magnitude and phase images without the DC bin → the
        generator's magnitude and phase."""
        m = self.patch_embed_mag(mag[..., None])
        p = self.patch_embed_phase(phase[..., None])
        skips = [(m, p)]
        for i in range(self.n):
            m = self.layers_encoder_mag[i](m, g)
            p = self.layers_encoder_phase[i](p, g)
            if i < self.n - 1:
                skips.append((m, p))
            m = m + p
            p = p + m
        for i, dec in enumerate(self.layers_decoder_mag):
            if i:
                sm, sp = skips.pop()
                m, p = torch.cat([m, sm], -1), torch.cat([p, sp], -1)
            m, p = dec(m, g), dec(p, g)
            m = m + p
            p = p + m
        sm, sp = skips.pop()
        m = self.output_layer_mag(torch.cat([m, sm], -1), g)
        p = self.output_layer_phase(torch.cat([p, sp], -1), g)
        return m[..., 0] + mag, p[..., 0]

    def forward(self, x, g=None):
        """x: (B, 1, T) waveform → (B, 1, T). ``g``: in training mode, the
        DropPath masks' source, a ``torch.Generator`` (``Drawn``) or a
        callable as ``Drawn`` is."""
        if isinstance(g, torch.Generator):
            g = Drawn(g)
        length = x.shape[-1]
        x = x[:, 0]
        if length % self.hop:
            x = F.pad(x, (0, self.hop - length % self.hop))
        mag, phase = wav2spectro(x, self.n_fft, self.hop, self.win)
        m, p = self.network(mag[:, 1:], phase[:, 1:], g)
        mag = torch.cat([mag[:, :1], m], dim=-2)
        phase = torch.cat([phase[:, :1], p], dim=-2)
        return spectro2wav(mag, phase, self.hop, self.win)[..., :length][:, None]
