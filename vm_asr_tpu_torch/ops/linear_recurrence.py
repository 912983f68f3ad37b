"""First-order linear recurrence ``h_t = a_t * h_{t-1} + b_t`` over (R, L, D).

Port of vm_asr_tpu/ops/linear_recurrence.py. ``linear_recurrence`` is a
``torch.autograd.Function`` (the JAX package's ``custom_vjp``). For CUDA
tensors its forward launches the kernel in ``csrc/linear_recurrence.cu`` (the
counterpart of the TPU kernel ``_lr_pallas``), and its backward launches the
same kernel in reverse (``linear_recurrence_reverse``, the counterpart of
``_lr_bwd``). For CPU tensors both directions run their plain versions. Each
forward launch adds one to ``linear_recurrence.launches``, each reverse launch
one to ``linear_recurrence_reverse.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .selective_scan_ref import linear_recurrence_ref

# The device kernels one launch runs, by pass, under the names torch.profiler
# gives them (demangled). chunk_carry_kernel (csrc/scan_common.cuh) is built
# into each scan library and carries every chunked scan's states.
CARRY_KERNEL = "vmasr::chunk_carry_kernel(float const*, float const*, float*, int, int, int)"
_LR_ARGS = ("(float const*, float const*, float const*, float*, float*, float*, float*, "
            "float const*, int, int, int, int, int)")


def _lr_kernel_name(write: bool, reverse: bool) -> str:
    flags = ", ".join(str(f).lower() for f in (write, reverse))
    return f"void vmasr::(anonymous namespace)::lr_chunk_kernel<{flags}>{_LR_ARGS}"


LR_KERNELS = {"fold": (_lr_kernel_name(False, False),), "carry": (CARRY_KERNEL,),
              "chunk": (_lr_kernel_name(True, False),)}
LR_REVERSE_KERNELS = {"fold": (_lr_kernel_name(False, True),), "carry": (CARRY_KERNEL,),
                      "chunk": (_lr_kernel_name(True, True),)}

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
    """The kernel's plain version: fp32 doubling scan along axis -2 (fp64
    for fp64 inputs)."""
    maths = torch.promote_types(a.dtype, torch.float32)
    return linear_recurrence_ref(a.to(maths), b.to(maths), dim=-2)


def linear_recurrence_reverse_plain(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    """The reverse kernel's plain version, the port of ``_lr_bwd``:
    dh_t = g_t + a_{t+1}·dh_{t+1} as a flipped scan, da = dh·h_{t-1}.
    Returns (da, db = dh), fp32."""
    af = a.float()
    a_next = torch.cat([af[:, 1:], torch.ones_like(af[:, :1])], dim=1)
    dh = linear_recurrence_ref(a_next.flip(1), g.float().flip(1), dim=-2).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1).float()
    return dh * h_prev, dh


def _kernel(reverse: bool):
    lib = load("linear_recurrence.cu")
    if reverse:
        fn = lib.vmasr_linear_recurrence_reverse
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    else:
        fn = lib.vmasr_linear_recurrence
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(*tensors):
    a = tensors[0]
    if a.device.type != "cuda" or any(t.device != a.device for t in tensors):
        raise ValueError(f"tensors must be on one CUDA device, got {[str(t.device) for t in tensors]}")
    if a.dim() != 3 or any(t.shape != a.shape for t in tensors):
        raise ValueError(f"expected (R, L, D) tensors of one shape, got {[tuple(t.shape) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"the kernel takes float32, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")


def _launch(reverse: bool, *ptrs, shape, device):
    r, l, d = shape
    chunk = chunk_length(r, l, d)
    n_chunks = -(-l // chunk)
    p, s, h0 = torch.empty((3, r, n_chunks, d), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(reverse)(*ptrs, p.data_ptr(), s.data_ptr(), h0.data_ptr(),
                               r, l, d, chunk, stream)
    if err:
        name = "linear_recurrence_reverse" if reverse else "linear_recurrence"
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def linear_recurrence_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on contiguous fp32 CUDA tensors (R, L, D)."""
    _check(a, b)
    h = torch.empty_like(a)
    _launch(False, a.data_ptr(), b.data_ptr(), h.data_ptr(), shape=a.shape, device=a.device)
    linear_recurrence.launches += 1
    return h


def linear_recurrence_reverse(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    """The recurrence's backward: given a, the forward's h and the gradient g
    of h, returns (da, db) with db_t = dh_t = g_t + a_{t+1}·dh_{t+1} and
    da_t = dh_t·h_{t-1}, fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel in
    reverse, on contiguous fp32 tensors of one shape and nothing else."""
    if all(t.device.type == "cpu" for t in (a, h, g)):
        return linear_recurrence_reverse_plain(a, h, g)
    _check(a, h, g)
    dh, da = torch.empty_like(a), torch.empty_like(a)
    _launch(True, a.data_ptr(), g.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
            shape=a.shape, device=a.device)
    linear_recurrence_reverse.launches += 1
    return da, dh


class _LinearRecurrence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        if a.device.type == "cpu" and b.device.type == "cpu":
            h = linear_recurrence_plain(a, b)
        else:
            h = linear_recurrence_fwd(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        da, db = linear_recurrence_reverse(a, h, g.float().contiguous())
        return da.to(a.dtype), db


def linear_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 of (R, L, D) fp32 tensors,
    differentiable in a and b.

    CPU tensors take the plain versions; CUDA tensors launch the kernels,
    which take contiguous fp32 tensors of one shape on one device, and
    nothing else."""
    if not (a.device.type == "cpu" and b.device.type == "cpu") and a.device.type != "cuda":
        raise ValueError(f"a and b must be on one CUDA device, got {a.device}, {b.device}")
    return _LinearRecurrence.apply(a, b)


linear_recurrence.launches = 0
linear_recurrence_reverse.launches = 0
