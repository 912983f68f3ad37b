"""Building-block layers of the Mamba U-Net, channels-last (NHWC).

Port of vm_asr_tpu/models/layers.py. Parameters are float32; each layer
computes in its ``compute_dtype`` the way flax's ``dtype=`` does: Linear and
Conv cast input, weight and bias to it and return it; LayerNorm takes its
statistics and affine in float32 and returns ``compute_dtype``. (Autocast
would return LayerNorm outputs in float32 and drift from the JAX package.)

Parameter names and shapes are the reference's (``torch_port.py`` maps them
onto the flax tree), so reference checkpoints load with ``load_state_dict``.
Every parameterised module initialises itself from a ``torch.Generator`` with
the JAX package's init distributions (``init_from``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.layer_norm import kernel_route, layer_norm, layer_norm_plain
from ..parallel.context import rand_rows

# flax truncated_normal(stddev=0.02, lower=-2, upper=2): stddev is that of the
# truncated law, so the underlying normal is wider by 1/0.8796.
_TRUNC_STD = 0.02 / 0.87962566103423978


def trunc_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return nn.init.trunc_normal_(t, std=_TRUNC_STD, a=-2 * _TRUNC_STD,
                                 b=2 * _TRUNC_STD, generator=generator)


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    return nn.init.uniform_(t, -bound, bound, generator=generator)


# F.gelu is the exact erf form, as torch's nn.GELU() and the JAX package's.
_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": F.gelu,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
}


def get_activation(name: str):
    return _ACTIVATIONS[name.lower()]


class Linear(nn.Linear):
    """flax ``Dense(dtype=compute_dtype)``.

    init "trunc_normal": kernel ~ truncated normal (std 0.02), bias 0 (the
    JAX package's Dense default). init "torch": torch's Linear/Conv default,
    kernel and bias ~ U(±1/sqrt(fan_in))."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 compute_dtype: torch.dtype = torch.float32, init: str = "trunc_normal"):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        self.init = init

    def init_from(self, generator: torch.Generator) -> None:
        if self.init == "trunc_normal":
            trunc_normal_(self.weight, generator)
            if self.bias is not None:
                nn.init.zeros_(self.bias)
        else:
            bound = 1.0 / math.sqrt(self.in_features)
            uniform_(self.weight, bound, generator)
            if self.bias is not None:
                uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv1x1(nn.Module):
    """A reference 1×1 ``nn.Conv2d`` (weight ``(out, in, 1, 1)``) applied to
    NHWC input as the flax Dense it is in the JAX package; torch init."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.compute_dtype = compute_dtype

    def init_from(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight[:, :, 0, 0].to(dt), self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """flax ``Conv(dtype=compute_dtype)`` on NHWC input; torch init for the
    kernel, zero bias (flax's default)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding)
        self.compute_dtype = compute_dtype

    def init_from(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        uniform_(self.weight, 1.0 / math.sqrt(fan_in), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt),
                     self.bias.to(dt), self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class DepthwiseConv2d(nn.Conv2d):
    """Depthwise k×k conv, stride 1, SAME padding, on NHWC input.

    The JAX package writes it as k·k shifted multiply-adds to dodge a GSPMD
    gradient bug (vm_asr_tpu/models/layers.py:70-79) that has no counterpart
    here, so it is a grouped ``nn.Conv2d``. Init: kernel and bias ~
    U(±1/sqrt(k·k))."""

    def __init__(self, channels: int, kernel_size: int = 3, bias: bool = True, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(channels, channels, kernel_size, padding=(kernel_size - 1) // 2,
                         groups=channels, bias=bias)
        self.compute_dtype = compute_dtype

    def init_from(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        uniform_(self.weight, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt), bias,
                     padding=self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm(dtype=compute_dtype)`` with torch's eps 1e-5:
    float32 statistics and affine, output in ``compute_dtype``.

    A call that autograd records nothing of on the card (the serving
    forward, the classifier, evaluation) takes the kernel, one launch
    (ops/layer_norm.py); the others take torch's route, its plain version,
    and torch's backward."""

    def __init__(self, dim: int, *, compute_dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-5)
        self.compute_dtype = compute_dtype

    def init_from(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if kernel_route(x, self.weight, self.bias, self.compute_dtype):
            return layer_norm(x, self.weight, self.bias, self.eps, self.compute_dtype)
        return layer_norm_plain(x, self.weight, self.bias, self.eps, self.compute_dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm semantics, vm_asr_tpu/models/layers.py
    DropPath): in training each sample is kept with probability 1 − rate and
    scaled by 1/keep; the identity in eval or at rate 0.

    The mask is drawn from ``generator``, a ``torch.Generator`` on x's device,
    never from the global RNG: training-mode calls with rate > 0 raise
    without one. Under data parallelism it is drawn for the global batch and
    cut to this rank's rows (``parallel.rand_rows``)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("DropPath in training mode draws from an explicit "
                             "torch.Generator; pass generator=")
        keep = 1.0 - self.rate
        draw = rand_rows((x.shape[0],) + (1,) * (x.dim() - 1), generator, x.device)
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """Element-wise dropout (flax ``nn.Dropout``): in training each element is
    kept with probability 1 − rate and scaled by 1/keep; the identity in eval
    or at rate 0, zeros at rate 1. The mask is drawn from ``generator``, as
    DropPath's is."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError("Dropout in training mode draws from an explicit "
                             "torch.Generator; pass generator=")
        keep = 1.0 - self.rate
        draw = rand_rows(x.shape, generator, x.device)
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """fc1 → act → dropout → fc2 → dropout (reference vmamba.py:483-509)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 act: str = "gelu", drop_rate: float = 0.0, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, compute_dtype=compute_dtype)
        self.fc2 = Linear(hidden_features, out_features, compute_dtype=compute_dtype)
        self.act = get_activation(act)
        self.drop = Dropout(drop_rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.drop(self.act(self.fc1(x)), generator)
        return self.drop(self.fc2(x), generator)


class GMlp(nn.Module):
    """Gated MLP (reference vmamba.py:512-538): fc1 to 2·hidden, split into
    (x, z), fc2(x · act(z)), dropout."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 act: str = "gelu", drop_rate: float = 0.0, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, 2 * hidden_features, compute_dtype=compute_dtype)
        self.fc2 = Linear(hidden_features, out_features, compute_dtype=compute_dtype)
        self.act = get_activation(act)
        self.drop = Dropout(drop_rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x, z = self.fc1(x).chunk(2, dim=-1)
        return self.drop(self.fc2(x * self.act(z)), generator)


class PatchMerging(nn.Module):
    """2× downsample: 2×2 space-to-depth → LN(4C) → Linear(4C → out_dim),
    gather order x0=(even,even), x1=(odd,even), x2=(even,odd), x3=(odd,odd)."""

    def __init__(self, dim: int, out_dim: int, *, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = LayerNorm(4 * dim, compute_dtype=compute_dtype)
        self.reduction = Linear(4 * dim, out_dim, bias=False, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x0 = x[:, 0::2, 0::2]
        x1 = x[:, 1::2, 0::2]
        x2 = x[:, 0::2, 1::2]
        x3 = x[:, 1::2, 1::2]
        return self.reduction(self.norm(torch.cat([x0, x1, x2, x3], dim=-1)))


class PatchExpanding(nn.Module):
    """2× upsample: Linear(C → 2C) → depth-to-space 2×2 → LN(C/2)."""

    def __init__(self, dim: int, use_norm: bool = True, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.expand = Linear(dim, 2 * dim, bias=False, compute_dtype=compute_dtype)
        self.norm = LayerNorm(dim // 2, compute_dtype=compute_dtype) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = self.expand(x)
        # 'b h w (p1 p2 c) -> b (h p1) (w p2) c' with p1 = p2 = 2
        x = x.reshape(b, h, w, 2, 2, c // 2).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, 2 * h, 2 * w, c // 2)
        return x if self.norm is None else self.norm(x)


class PatchEmbed(nn.Sequential):
    """Patch embedding, NHWC (reference model.py:580-633).

    v2: conv 3×3/s2 → LN → GELU → conv 3×3/s2 → LN, in slots 0/2/5/7, which
    hold the reference's conv1/norm1/conv2/norm2 (its Sequential has permutes
    and the GELU between them).
    v1: one patch_size × patch_size conv of stride patch_size → LN, in slots
    0/2 (the reference's Conv2d, Permute, LN); the image's sides are
    multiples of the patch (flax's "SAME" padding then pads nothing).
    So the state_dict keys are the reference's ``patch_embed*.{0,2,5,7}.*``."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 4,
                 version: str = "v2", patch_norm: bool = True, *,
                 compute_dtype: torch.dtype = torch.float32):
        norm = (lambda d: LayerNorm(d, compute_dtype=compute_dtype)) if patch_norm \
            else (lambda d: nn.Identity())
        if version == "v1":
            super().__init__(
                Conv2d(in_chans, embed_dim, patch_size, patch_size, compute_dtype=compute_dtype),
                nn.Identity(),
                norm(embed_dim),
            )
        elif version == "v2":
            if patch_size != 4:
                raise ValueError(f"the v2 patch embed downsamples by 4, not {patch_size}")
            super().__init__(
                Conv2d(in_chans, embed_dim // 2, 3, 2, 1, compute_dtype=compute_dtype),
                nn.Identity(),
                norm(embed_dim // 2),
                nn.Identity(),
                nn.Identity(),
                Conv2d(embed_dim // 2, embed_dim, 3, 2, 1, compute_dtype=compute_dtype),
                nn.Identity(),
                norm(embed_dim),
            )
        else:
            raise ValueError(f"unknown patch embed version {version!r}")
        self.version = version

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.version == "v1":
            return self[2](self[0](x))
        x = F.gelu(self[2](self[0](x)))
        return self[7](self[5](x))


class ConvTranspose2d(nn.ConvTranspose2d):
    """flax ``ConvTranspose(k, strides=2, padding="SAME", dtype=compute_dtype)``
    on NHWC input: a torch transposed conv at padding 0 (output (H−1)·2 + k)
    cropped to the first 2H × 2W. Its weight (in, out, kh, kw) is the flax
    kernel (kh, kw, in, out) flipped in both spatial axes (flax's transposed
    conv does not flip, torch's does) and permuted. Init: kernel ~
    U(±1/sqrt(kh·kw·in)) (flax ``torch_linear_init`` over its kernel), zero
    bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 2, *, compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride)
        self.compute_dtype = compute_dtype

    def init_from(self, generator: torch.Generator) -> None:
        kh, kw = self.kernel_size
        uniform_(self.weight, 1.0 / math.sqrt(kh * kw * self.in_channels), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h, w = x.shape[1], x.shape[2]
        sh, sw = self.stride
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt),
                               self.bias.to(dt), self.stride)
        return y[:, :, :h * sh, :w * sw].permute(0, 2, 3, 1)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameterised submodule of ``module`` from
    ``generator``, in module order."""
    for m in module.modules():
        init = getattr(m, "init_from", None)
        if init is not None:
            init(generator)
