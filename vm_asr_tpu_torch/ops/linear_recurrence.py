"""First-order linear recurrence ``h_t = a_t * h_{t-1} + b_t`` over (R, L, D).

Port of vm_asr_tpu/ops/linear_recurrence.py. ``linear_recurrence`` is the
wrapper of the CUDA kernel in ``csrc/linear_recurrence.cu`` (the counterpart
of the TPU kernel ``_lr_pallas``): it launches the kernel for CUDA tensors and
runs the plain version for CPU tensors. Each kernel launch adds one to
``linear_recurrence.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .selective_scan_ref import linear_recurrence_ref

# Threads the chunked kernels aim to start: about one full load of the
# card's 132 SMs × 2048 resident threads.
_TARGET_THREADS = 1 << 18
_MIN_CHUNK, _MAX_CHUNK = 16, 1024


def chunk_length(rows: int, length: int, channels: int) -> int:
    """L-chunk of the chunked scan kernels: the power of two (16..1024) that
    gives each of about ``_TARGET_THREADS`` threads one chunk of one channel."""
    want = -(-rows * length * channels // _TARGET_THREADS)
    chunk = _MIN_CHUNK
    while chunk < want and chunk < _MAX_CHUNK:
        chunk *= 2
    return chunk


def linear_recurrence_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: fp32 doubling scan along axis -2."""
    return linear_recurrence_ref(a.float(), b.float(), dim=-2)


def _kernel():
    fn = load("linear_recurrence.cu").vmasr_linear_recurrence
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def linear_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 of (R, L, D) fp32 tensors.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes contiguous fp32 tensors of one shape on one device, and nothing
    else."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return linear_recurrence_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"a and b must be on one CUDA device, got {a.device}, {b.device}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"expected two (R, L, D) tensors, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the kernel takes contiguous tensors")
    r, l, d = a.shape
    chunk = chunk_length(r, l, d)
    n_chunks = -(-l // chunk)
    h = torch.empty_like(a)
    p, s, h0 = torch.empty((3, r, n_chunks, d), dtype=torch.float32, device=a.device)
    fn = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), p.data_ptr(),
                 s.data_ptr(), h0.data_ptr(), r, l, d, chunk, stream)
    if err:
        raise RuntimeError(f"linear_recurrence kernel launch failed: cudaError {err}")
    linear_recurrence.launches += 1
    return h


linear_recurrence.launches = 0
