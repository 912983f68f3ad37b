"""The precision of the reference's products.

``Products("fp32")`` is the reference: every product in float32 with TF32
off. ``Products("fp8")`` is the control: each operand of every product is
rounded to float8 e4m3 with one scale a tensor (its largest magnitude mapped
to e4m3's largest finite value), and each gradient flowing back into an
operand to float8 e5m2 the same way, the usual fp8 training recipe and the
step below bfloat16 that a later change could be tempted to take.
``Products("bf16")`` rounds the operands and their gradients to bfloat16,
the program's own precision: a witness, independent of the program, of how
far bf16's rounding alone moves a reading. The arithmetic after the
rounding stays float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("fp32", "bf16", "fp8")
# (forward operands, gradients into them) of each rounded mode.
ROUNDING = {"bf16": (torch.bfloat16, torch.bfloat16),
            "fp8": (torch.float8_e4m3fn, torch.float8_e5m2)}


def set_plain_float32() -> None:
    """float32 products on the card are float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:  # float32's range: no scale
        return x.to(dtype).to(x.dtype)
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return _round(x, ROUNDING[mode][0])

    @staticmethod
    def backward(ctx, g):
        return _round(g, ROUNDING[ctx.mode][1]), None


class Products:
    """linear, conv1d/2d and einsum at the reference's precision."""

    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Rounded.apply(x, self.mode) if self.mode in ROUNDING else x

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv2d(self, x, w, b, stride=1, padding=0, groups=1):
        return F.conv2d(self.q(x), self.q(w), b, stride, padding, 1, groups)

    def einsum(self, spec, a, b):
        return torch.einsum(spec, self.q(a), self.q(b))
