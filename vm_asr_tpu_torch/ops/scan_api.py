"""Selective-scan API in the JAX package's (B, L, K, D) layout.

Port of vm_asr_tpu/ops/scan_api.py. The N = 1 case with K·D ≥ 128 goes to the
fused kernel; every other case runs the prologue and epilogue in torch
around the linear-recurrence kernel:

    dt  = softplus(dts + dt_bias)                 (fp32)
    a_n = exp(dt * A_n);  b_n = dt * B_n * u
    h_n = linear_recurrence(a_n, b_n)
    y   = Σ_n C_n * h_n + D_skip * u

The maths is fp32 and y comes back in u's dtype. ``fp32_io`` casts the
activations to fp32 before the scan (MODEL.VSSM.SCAN_FP32_IO, the
reference's force_fp32 at the scan boundary); the scan then returns fp32.

``impl="kernel"`` calls the kernel wrappers, which run their plain versions
for CPU tensors; ``impl="plain"`` calls the plain versions on any device, so
that a run on the card can hold the kernels against them; ``impl="plain64"``
runs the plain versions in fp64, a witness that shows how far the fp32
routes' rounding moves a result. The routes are
differentiable: the kernel wrappers are autograd Functions whose backward is a
kernel (fused backward; the recurrence run in reverse), and the plain
versions are torch ops under plain autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from .linear_recurrence import linear_recurrence, linear_recurrence_plain
from .selective_scan_fused import selective_scan_fused, selective_scan_fused_plain
from .selective_scan_ref import softplus

IMPLS = ("kernel", "plain", "plain64")


def selective_scan(
    u: torch.Tensor,         # (B, L, K, D): post-conv activations per direction
    dts: torch.Tensor,       # (B, L, K, D): raw Δ before bias and softplus
    A: torch.Tensor,         # (K, D, N): negative decay rates
    Bs: torch.Tensor,        # (B, L, K, N)
    Cs: torch.Tensor,        # (B, L, K, N)
    D_skip: Optional[torch.Tensor] = None,   # (K, D)
    dt_bias: Optional[torch.Tensor] = None,  # (K, D)
    delta_softplus: bool = True,
    fp32_io: bool = False,
    impl: str = "kernel",
) -> torch.Tensor:
    """Returns y: (B, L, K, D) in u's dtype; scan maths in fp32 (fp64 for
    ``impl="plain64"``)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if fp32_io:
        u, dts, Bs, Cs = (t.float() for t in (u, dts, Bs, Cs))
    in_dtype = u.dtype
    maths = torch.float64 if impl == "plain64" else torch.float32
    if impl == "plain64":
        u = u.double()
    b, l, k, d = u.shape
    n = A.shape[-1]

    if (
        n == 1
        and delta_softplus
        and D_skip is not None
        and dt_bias is not None
        # Narrow heads (K·D = 64, 8) take the recurrence kernel, as in the
        # JAX package, which keeps the fused kernel to lane-dense widths.
        and k * d >= 128
    ):
        fused = selective_scan_fused if impl == "kernel" else selective_scan_fused_plain
        y = fused(
            u.reshape(b, l, k * d).contiguous(),
            dts.to(u.dtype).reshape(b, l, k * d).contiguous(),
            Bs[..., 0].to(u.dtype).contiguous(),
            Cs[..., 0].to(u.dtype).contiguous(),
            A[..., 0].to(maths).reshape(k * d).contiguous(),
            dt_bias.to(maths).reshape(k * d).contiguous(),
            D_skip.to(maths).reshape(k * d).contiguous(),
            k,
        )
        return y.reshape(b, l, k, d).to(in_dtype)

    recur = linear_recurrence if impl == "kernel" else linear_recurrence_plain
    uf = u.to(maths)
    dt = dts.to(maths)
    if dt_bias is not None:
        dt = dt + dt_bias.to(maths)[None, None]
    if delta_softplus:
        dt = softplus(dt)
    Af = A.to(maths)
    dtu = dt * uf
    y = torch.zeros_like(uf)
    for i in range(n):
        a = torch.exp(dt * Af[None, None, :, :, i])
        bi = dtu * Bs[..., i:i + 1].to(maths)
        h = recur(a.reshape(b, l, k * d), bi.reshape(b, l, k * d)).reshape(b, l, k, d)
        y = y + h * Cs[..., i:i + 1].to(maths)
    if D_skip is not None:
        y = y + D_skip.to(maths)[None, None] * uf
    return y.to(in_dtype)
