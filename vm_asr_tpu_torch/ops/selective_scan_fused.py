"""Fused N=1 selective scan, forward and backward, in (B, L, K·D) layout.

Port of vm_asr_tpu/ops/selective_scan_fused.py:

    dt = softplus(dts + bias);  a = exp(dt·A);  b = dt·u·B_k
    h  = scan(a, b);            y = C_k·h + D_skip·u

with channel q = k·D + d and B, C given per direction k.
``selective_scan_fused`` is a ``torch.autograd.Function`` (the JAX package's
``custom_vjp``). For CUDA tensors its forward launches the kernel in
``csrc/fused_scan.cu`` (the counterpart of the TPU kernel
``_fused_fwd_pallas``) and keeps the chunk-entry states ``H0`` and the chunk
length; its backward launches the kernel in ``csrc/fused_scan_bwd.cu`` (the
counterpart of ``_fused_bwd_pallas``), which rebuilds h from them. For CPU
tensors both directions run their plain versions, and the plain backward
ignores ``H0``. Each launch adds one to ``selective_scan_fused.launches`` or
``selective_scan_fused_bwd.launches``.
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
    """The forward kernel's plain version: the same fp32 maths in torch ops
    (fp64 maths for fp64 inputs)."""
    d_inner = u.shape[-1] // k_group
    uf, dts, bs, cs, a_neg, dt_bias, d_skip = (
        t.to(torch.promote_types(u.dtype, torch.float32))
        for t in (u, dts, bs, cs, a_neg, dt_bias, d_skip))
    dt = softplus(dts + dt_bias)
    a = torch.exp(dt * a_neg)
    b_lanes = bs.repeat_interleave(d_inner, dim=-1)
    c_lanes = cs.repeat_interleave(d_inner, dim=-1)
    h = linear_recurrence_ref(a, (dt * uf) * b_lanes, dim=-2)
    return (c_lanes * h + d_skip * uf).to(u.dtype)


def selective_scan_fused_bwd_plain(u, dts, bs, cs, dy, a_neg, dt_bias, d_skip,
                                   k_group: int):
    """The backward kernel's plain version, the port of ``_fused_bwd_xla``
    (selective_scan_fused.py:496-554): recompute h, run the adjoint
    g_t = C_t·dy_t + a_{t+1}·g_{t+1} as a flipped scan, all in fp32.

    Returns (du, ddts, dbs, dcs) in the dtypes of (u, dts, bs, cs) and
    (dA, dbias, dD) in fp32."""
    bsz, l, kd = u.shape
    d = kd // k_group
    uf, dyf = u.float(), dy.float()
    bl = bs.float().repeat_interleave(d, dim=-1)
    cl = cs.float().repeat_interleave(d, dim=-1)
    raw = dts.float() + dt_bias.float()
    dt = softplus(raw)
    sig = torch.sigmoid(raw)
    a = torch.exp(dt * a_neg.float())
    h = linear_recurrence_ref(a, dt * uf * bl, dim=-2)
    a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
    g = linear_recurrence_ref(a_next.flip(1), (dyf * cl).flip(1), dim=-2).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)

    da = g * h_prev
    ddts = (da * a * a_neg.float() + g * uf * bl) * sig
    du = g * dt * bl + dyf * d_skip.float()

    def from_lanes(v):  # (B, L, KD) → (B, L, K): sum over D within a direction
        return v.reshape(bsz, l, k_group, d).sum(-1)

    return (du.to(u.dtype), ddts.to(dts.dtype),
            from_lanes(g * dt * uf).to(bs.dtype), from_lanes(dyf * h).to(cs.dtype),
            (da * a * dt).sum((0, 1)), ddts.sum((0, 1)), (dyf * uf).sum((0, 1)))


def _fwd_kernel():
    fn = load("fused_scan.cu").vmasr_fused_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bwd_kernel():
    fn = load("fused_scan_bwd.cu").vmasr_fused_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def selective_scan_fused_fwd(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group: int):
    """Launch the forward kernel on CUDA tensors. Returns (y, H0, chunk): y
    (B, L, K·D) in u's dtype, H0 (B, n_chunks, K·D) fp32 the state entering
    each L-chunk of length ``chunk``."""
    if u.device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {u.device}")
    _check(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group)
    bsz, l, kd = u.shape
    chunk = chunk_length(bsz, l, kd)
    n_chunks = -(-l // chunk)
    y = torch.empty_like(u)
    p, s, h0 = torch.empty((3, bsz, n_chunks, kd), dtype=torch.float32, device=u.device)
    err = _fwd_kernel()(u.data_ptr(), dts.data_ptr(), bs.data_ptr(), cs.data_ptr(),
                        a_neg.data_ptr(), dt_bias.data_ptr(), d_skip.data_ptr(),
                        y.data_ptr(), p.data_ptr(), s.data_ptr(), h0.data_ptr(),
                        bsz, l, kd, k_group, chunk, int(u.dtype == torch.bfloat16),
                        _stream(u.device))
    if err:
        raise RuntimeError(f"selective_scan_fused kernel launch failed: cudaError {err}")
    selective_scan_fused.launches += 1
    return y, h0, chunk


def selective_scan_fused_bwd(u, dts, bs, cs, dy, a_neg, dt_bias, d_skip, h0,
                             chunk: int, k_group: int):
    """The seven gradients of the fused scan: (du, ddts, dbs, dcs) in the
    dtypes of (u, dts, bs, cs), (dA, dbias, dD) fp32.

    CPU tensors take the plain version (which ignores ``h0`` and ``chunk``);
    CUDA tensors launch the backward kernel, which needs ``h0`` and ``chunk``
    from the forward kernel."""
    if _on_cpu(u, dts, bs, cs, dy, a_neg, dt_bias, d_skip):
        return selective_scan_fused_bwd_plain(u, dts, bs, cs, dy, a_neg, dt_bias,
                                              d_skip, k_group)
    if u.device.type != "cuda":
        raise ValueError(f"expected CUDA or CPU tensors, got {u.device}")
    _check(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group)
    bsz, l, kd = u.shape
    n_chunks = -(-l // chunk)
    if h0 is None or h0.shape != (bsz, n_chunks, kd) or h0.dtype != torch.float32 \
            or h0.device != u.device or not h0.is_contiguous():
        raise ValueError(f"H0 must be a contiguous fp32 {(bsz, n_chunks, kd)} tensor on {u.device}")
    if dy.shape != u.shape or dy.dtype != u.dtype or dy.device != u.device \
            or not dy.is_contiguous():
        raise ValueError("dy must be a contiguous tensor of u's shape, dtype and device")
    du, ddts = torch.empty_like(u), torch.empty_like(dts)
    dbs, dcs = torch.zeros((2, bsz, l, k_group), dtype=torch.float32, device=u.device)
    dparams = torch.empty((3, kd), dtype=torch.float32, device=u.device)
    p, s, g = torch.empty((3, bsz, n_chunks, kd), dtype=torch.float32, device=u.device)
    part = torch.empty((3, bsz * n_chunks, kd), dtype=torch.float32, device=u.device)
    err = _bwd_kernel()(
        u.data_ptr(), dts.data_ptr(), bs.data_ptr(), cs.data_ptr(), dy.data_ptr(),
        a_neg.data_ptr(), dt_bias.data_ptr(), d_skip.data_ptr(), h0.data_ptr(),
        du.data_ptr(), ddts.data_ptr(), dbs.data_ptr(), dcs.data_ptr(),
        dparams.data_ptr(), p.data_ptr(), s.data_ptr(), g.data_ptr(), part.data_ptr(),
        bsz, l, kd, k_group, chunk, int(u.dtype == torch.bfloat16), _stream(u.device))
    if err:
        raise RuntimeError(f"selective_scan_fused_bwd kernel launch failed: cudaError {err}")
    selective_scan_fused_bwd.launches += 1
    return (du, ddts, dbs.to(bs.dtype), dcs.to(cs.dtype), dparams[0], dparams[1],
            dparams[2])


class _FusedScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group):
        if _on_cpu(u, dts, bs, cs, a_neg, dt_bias, d_skip):
            y, h0, chunk = selective_scan_fused_plain(
                u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group), None, None
        else:
            y, h0, chunk = selective_scan_fused_fwd(u, dts, bs, cs, a_neg, dt_bias,
                                                    d_skip, k_group)
        ctx.save_for_backward(u, dts, bs, cs, a_neg, dt_bias, d_skip, h0)
        ctx.chunk, ctx.k_group = chunk, k_group
        return y

    @staticmethod
    def backward(ctx, dy):
        u, dts, bs, cs, a_neg, dt_bias, d_skip, h0 = ctx.saved_tensors
        grads = selective_scan_fused_bwd(
            u, dts, bs, cs, dy.to(u.dtype).contiguous(), a_neg, dt_bias, d_skip, h0,
            ctx.chunk, ctx.k_group)
        return (*grads, None)


def selective_scan_fused(u, dts, bs, cs, a_neg, dt_bias, d_skip,
                         k_group: int) -> torch.Tensor:
    """Fused N=1 selective scan, differentiable in its seven tensor inputs.
    Returns y: (B, L, K·D) in u's dtype.

    Args:
      u, dts:  (B, L, K·D), float32 or bfloat16, channel q = k·D + d
      bs, cs:  (B, L, K), u's dtype
      a_neg:   (K·D,) float32, A = -exp(A_logs)
      dt_bias: (K·D,) float32
      d_skip:  (K·D,) float32
    CPU tensors take the plain versions; CUDA tensors launch the kernels,
    which take contiguous tensors of these shapes and dtypes and nothing
    else."""
    if not _on_cpu(u, dts, bs, cs, a_neg, dt_bias, d_skip) and u.device.type != "cuda":
        raise ValueError(f"expected CUDA or CPU tensors, got {u.device}")
    return _FusedScan.apply(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group)


selective_scan_fused.launches = 0
selective_scan_fused_bwd.launches = 0
