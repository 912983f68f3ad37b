"""Fused selective scan forward for N = 16 states, in (B, L, K·D) layout:

    dt  = softplus(dts + bias)                    (fp32, once a step)
    h_n = exp(dt·A_n)·h_n + dt·u·B_n              (16 fp32 states)
    y   = Σ_n C_n·h_n + D_skip·u

with channel q = k·D + d and B, C given per direction k and state n. For
CUDA tensors ``selective_scan_nstate`` launches the kernel in
``csrc/nstate_scan.cu`` (one launch per call, no workspace), which replaces
no TPU kernel: it does in one pass what ``ops/scan_api.py``'s general-N
loop does with a recurrence launch and a handful of torch passes per state
channel. For CPU tensors it runs its plain version, that loop with the
plain recurrence. Forward only: ``ops/scan_api.py`` routes a scan here only
when no gradient is needed, and keeps the general-N loop, whose backward is
the reverse recurrence, for the others. Each launch adds one to
``selective_scan_nstate.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .build import load
from .lookback import current_stream

# The states the kernel is compiled for (d_state 16: VMamba's SS2D).
NSTATE_N = 16
_IO_DTYPES = (torch.float32, torch.bfloat16)

# The device kernel one launch runs, under the names torch.profiler gives it
# (demangled): one instance per IO dtype and per lanes a chain.
_NS = "vmasr::(anonymous namespace)::"
_LANES = (1, 2, 4, 8, 16)
NSTATE_KERNELS = {
    "scan": tuple(f"void {_NS}nstate_fwd_kernel<{t}, {NSTATE_N}, {s}>({_NS}NsArgs, "
                  f"{_NS}NsTile)" for t in ("__nv_bfloat16", "float") for s in _LANES),
}

# The kernel's geometry (csrc/nstate_scan.cu): tiles of 16 steps, at most
# 128 threads a CTA, and as many lanes a chain as it takes to start 2^16
# threads (about half of what the card holds at 80 registers a thread).
_NS_STEPS = 16
_NS_MAX_THREADS = 128
_NS_TARGET_THREADS = 1 << 16


def _r16(n: int) -> int:
    return -(-n // 16) * 16


class NstateTileLayout(NamedTuple):
    lanes: int       # threads a chain, each with N / lanes of its states
    channels: int    # per CTA: a divisor of D, all of one direction
    threads: int     # channels × lanes, rounded up to a warp
    smem_bytes: int  # dynamic shared memory per CTA


def nstate_tile_smem(channels: int, n: int, itemsize: int) -> int:
    """Shared memory of one CTA (csrc/nstate_scan.cu:ns_smem_bytes): two
    buffers, each of u and dts for 16 steps of ``channels`` and of B and C
    for 16 steps of ``n``, in the IO dtype, each array rounded up to 16
    bytes; and for bf16 one fp32 copy of B and C."""
    buf = 2 * _r16(_NS_STEPS * channels * itemsize) + _r16(_NS_STEPS * 2 * n * itemsize)
    return 2 * buf + (0 if itemsize == 4 else _r16(_NS_STEPS * 2 * n * 4))


@functools.lru_cache(maxsize=None)
def nstate_tile_layout(bsz: int, kd: int, k_group: int, n: int, itemsize: int) -> NstateTileLayout:
    """Geometry of the kernel for (``bsz``, L, ``kd``) inputs with ``n``
    states, of ``itemsize`` bytes. Lanes: the fewest (1, 2, 4, 8, 16) with
    B·K·D × lanes ≥ 2^16 threads, so that every batch-128 VMamba-T scan
    walks a chain in one thread and batch 8 splits its states; channels: the
    largest divisor of D that fits 128 threads with its lanes."""
    if n != NSTATE_N:
        raise ValueError(f"the kernel is compiled for N = {NSTATE_N}, got N = {n}")
    if min(bsz, kd, k_group) <= 0 or kd % k_group:
        raise ValueError(f"B = {bsz}, K·D = {kd}, K = {k_group}: K·D must be a positive "
                         "multiple of K")
    if itemsize not in (2, 4):
        raise ValueError(f"the kernel takes bf16 or fp32, not {itemsize}-byte items")
    d = kd // k_group
    lanes = 1
    while lanes < n and bsz * kd * lanes < _NS_TARGET_THREADS:
        lanes *= 2
    channels = max(g for g in range(1, min(d, _NS_MAX_THREADS // lanes) + 1) if d % g == 0)
    if bsz * (kd // channels) > 2**31 - 1:
        raise ValueError(f"(B, K·D) = {(bsz, kd)} has more CTAs than a grid takes")
    threads = -(-channels * lanes // 32) * 32
    return NstateTileLayout(lanes, channels, threads, nstate_tile_smem(channels, n, itemsize))


def selective_scan_nstate_plain(u, dts, bs, cs, a_neg, dt_bias, d_skip,
                                k_group: int) -> torch.Tensor:
    """The kernel's plain version: ``ops/scan_api.py``'s general-N loop
    with the plain recurrence (``impl="plain"``), in fp32, on the same
    (B, L, K·D) operands. Returns y in u's dtype."""
    from .scan_api import selective_scan  # which routes to this module

    bsz, l, kd = u.shape
    k, d = k_group, kd // k_group
    y = selective_scan(u.reshape(bsz, l, k, d), dts.reshape(bsz, l, k, d),
                       a_neg.reshape(k, d, -1), bs, cs, d_skip.reshape(k, d),
                       dt_bias.reshape(k, d), impl="plain")
    return y.reshape(bsz, l, kd)


@functools.cache
def _kernel():
    fn = load("nstate_scan.cu").vmasr_nstate_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
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
    n = a_neg.shape[-1] if a_neg.dim() == 2 else -1
    if a_neg.shape != (kd, n) or n != NSTATE_N:
        raise ValueError(f"A must be ({kd}, {NSTATE_N}), got {tuple(a_neg.shape)}")
    if bs.shape != (bsz, l, k_group, n) or cs.shape != bs.shape:
        raise ValueError(f"bs, cs must be {(bsz, l, k_group, n)}, got {tuple(bs.shape)}, "
                         f"{tuple(cs.shape)}")
    if dt_bias.shape != (kd,) or d_skip.shape != (kd,):
        raise ValueError(f"dt_bias, D_skip must be ({kd},), got {tuple(dt_bias.shape)}, "
                         f"{tuple(d_skip.shape)}")
    if u.dtype not in _IO_DTYPES or any(t.dtype != u.dtype for t in (dts, bs, cs)):
        raise TypeError("u, dts, bs, cs must share one dtype, float32 or bfloat16")
    if any(p.dtype != torch.float32 for p in (a_neg, dt_bias, d_skip)):
        raise TypeError("A, dt_bias, D_skip must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")


def selective_scan_nstate(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group: int) -> torch.Tensor:
    """Selective scan with N = 16 states, forward only (no autograd).
    Returns y: (B, L, K·D) in u's dtype.

    Args:
      u, dts:  (B, L, K·D), float32 or bfloat16, channel q = k·D + d
      bs, cs:  (B, L, K, N), u's dtype
      a_neg:   (K·D, N) float32, A = -exp(A_logs)
      dt_bias: (K·D,) float32
      d_skip:  (K·D,) float32
    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes contiguous tensors of these shapes and dtypes with N = 16, and
    nothing else."""
    tensors = (u, dts, bs, cs, a_neg, dt_bias, d_skip)
    if all(t.device.type == "cpu" for t in tensors):
        return selective_scan_nstate_plain(*tensors, k_group)
    if u.device.type != "cuda":
        raise ValueError(f"expected CUDA or CPU tensors, got {u.device}")
    _check(*tensors, k_group)
    bsz, l, kd = u.shape
    tile = nstate_tile_layout(bsz, kd, k_group, a_neg.shape[-1], u.element_size())
    y = torch.empty_like(u)
    err = _kernel()(*(t.data_ptr() for t in tensors), y.data_ptr(), bsz, l, kd, k_group,
                    a_neg.shape[-1], int(u.dtype == torch.bfloat16), *tile,
                    current_stream(u.device))
    if err:
        raise RuntimeError(f"selective_scan_nstate kernel launch failed: cudaError {err}")
    selective_scan_nstate.launches += 1
    return y


selective_scan_nstate.launches = 0
