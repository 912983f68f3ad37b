"""Fused N=1 selective scan, forward, in (B, L, K·D) layout.

Port of the forward of vm_asr_tpu/ops/selective_scan_fused.py:

    dt = softplus(dts + bias);  a = exp(dt·A);  b = dt·u·B_k
    h  = scan(a, b);            y = C_k·h + D_skip·u

with channel q = k·D + d and B, C given per direction k. ``selective_scan_fused``
is the wrapper of the CUDA kernel in ``csrc/fused_scan.cu`` (the counterpart of
the TPU kernel ``_fused_fwd_pallas``): it launches the kernel for CUDA tensors
and runs the plain version for CPU tensors. Each kernel launch adds one to
``selective_scan_fused.launches``. The backward kernel is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .linear_recurrence import chunk_length
from .selective_scan_ref import linear_recurrence_ref, softplus

_IO_DTYPES = (torch.float32, torch.bfloat16)


def selective_scan_fused_plain(u, dts, bs, cs, a_neg, dt_bias, d_skip,
                               k_group: int) -> torch.Tensor:
    """The kernel's plain version: the same fp32 maths in torch ops."""
    d_inner = u.shape[-1] // k_group
    uf = u.float()
    dt = softplus(dts.float() + dt_bias.float())
    a = torch.exp(dt * a_neg.float())
    b_lanes = bs.float().repeat_interleave(d_inner, dim=-1)
    c_lanes = cs.float().repeat_interleave(d_inner, dim=-1)
    h = linear_recurrence_ref(a, (dt * uf) * b_lanes, dim=-2)
    return (c_lanes * h + d_skip.float() * uf).to(u.dtype)


def _kernel():
    fn = load("fused_scan.cu").vmasr_fused_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group):
    tensors = (u, dts, bs, cs, a_neg, dt_bias, d_skip)
    if any(t.device != u.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if u.dim() != 3 or dts.shape != u.shape:
        raise ValueError(f"u, dts must be (B, L, K·D), got {tuple(u.shape)}, {tuple(dts.shape)}")
    bsz, l, kd = u.shape
    if k_group <= 0 or kd % k_group:
        raise ValueError(f"K·D = {kd} is not a multiple of K = {k_group}")
    if bs.shape != (bsz, l, k_group) or cs.shape != bs.shape:
        raise ValueError(f"bs, cs must be {(bsz, l, k_group)}, got {tuple(bs.shape)}, {tuple(cs.shape)}")
    if any(p.shape != (kd,) for p in (a_neg, dt_bias, d_skip)):
        raise ValueError(f"A, dt_bias, D_skip must be ({kd},)")
    if u.dtype not in _IO_DTYPES or any(t.dtype != u.dtype for t in (dts, bs, cs)):
        raise TypeError("u, dts, bs, cs must share one dtype, float32 or bfloat16")
    if any(p.dtype != torch.float32 for p in (a_neg, dt_bias, d_skip)):
        raise TypeError("A, dt_bias, D_skip must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")


def selective_scan_fused(u, dts, bs, cs, a_neg, dt_bias, d_skip,
                         k_group: int) -> torch.Tensor:
    """Fused N=1 selective scan. Returns y: (B, L, K·D) in u's dtype.

    Args:
      u, dts:  (B, L, K·D), float32 or bfloat16, channel q = k·D + d
      bs, cs:  (B, L, K), u's dtype
      a_neg:   (K·D,) float32, A = -exp(A_logs)
      dt_bias: (K·D,) float32
      d_skip:  (K·D,) float32
    """
    if u.device.type == "cpu" and all(
        t.device.type == "cpu" for t in (dts, bs, cs, a_neg, dt_bias, d_skip)
    ):
        return selective_scan_fused_plain(u, dts, bs, cs, a_neg, dt_bias,
                                          d_skip, k_group)
    if u.device.type != "cuda":
        raise ValueError(f"expected CUDA or CPU tensors, got {u.device}")
    _check(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group)
    bsz, l, kd = u.shape
    chunk = chunk_length(bsz, l, kd)
    n_chunks = -(-l // chunk)
    y = torch.empty_like(u)
    p, s, h0 = torch.empty((3, bsz, n_chunks, kd), dtype=torch.float32, device=u.device)
    fn = _kernel()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(u.data_ptr(), dts.data_ptr(), bs.data_ptr(), cs.data_ptr(),
                 a_neg.data_ptr(), dt_bias.data_ptr(), d_skip.data_ptr(),
                 y.data_ptr(), p.data_ptr(), s.data_ptr(), h0.data_ptr(),
                 bsz, l, kd, k_group, chunk, int(u.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"selective_scan_fused kernel launch failed: cudaError {err}")
    selective_scan_fused.launches += 1
    return y


selective_scan_fused.launches = 0
