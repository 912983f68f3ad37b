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
routes' rounding moves a result. The routes are differentiable: the kernel
wrappers are autograd Functions whose backward is a kernel (fused backward;
the recurrence run in reverse), or with ``checkpointed`` the same as
dispatcher ops, and the plain versions are torch ops under plain autograd.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .linear_recurrence import linear_recurrence, linear_recurrence_plain
from .selective_scan_fused import selective_scan_fused, selective_scan_fused_plain
from .selective_scan_ref import softplus

IMPLS = ("kernel", "plain", "plain64")

# The dispatcher ops that produce the scans' outputs on the "kernel" route
# with ``checkpointed``: a selective activation checkpoint keeps their
# outputs and recomputes the rest (models/vss.py), the JAX package's
# save_only_these_names("scan_out").
SCAN_OUTPUT_OPS = (torch.ops.vmasr.fused_scan.default, torch.ops.vmasr.linear_recurrence.default)


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
    checkpointed: bool = False,
    lanes: Optional[int] = None,
) -> torch.Tensor:
    """Returns y: (B, L, K, D) in u's dtype; scan maths in fp32 (fp64 for
    ``impl="plain64"``). ``checkpointed``: the call runs inside a selective
    activation checkpoint, so the kernel route takes the dispatcher ops of
    ``SCAN_OUTPUT_OPS``, whose outputs the checkpoint's policy keeps.
    ``lanes``: the K·D the route is chosen by, when this call scans one
    rank's share of the directions (the ``mp`` split, models/ss2d.py): the
    global width, as the JAX package insists, so that splitting a stage
    does not move its shares off the fused kernel."""
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
        and (lanes or k * d) >= 128
    ):
        fused = functools.partial(selective_scan_fused, as_op=checkpointed) \
            if impl == "kernel" else selective_scan_fused_plain
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

    recur = functools.partial(linear_recurrence, as_op=checkpointed) \
        if impl == "kernel" else linear_recurrence_plain
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
