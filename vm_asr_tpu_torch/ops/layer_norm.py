"""LayerNorm over the last dimension, forward: fp32 statistics and affine,
one rounding to the output dtype, as ``models/layers.py:LayerNorm`` computes
it (flax's ``LayerNorm(dtype=compute_dtype)`` with torch's eps).

For CUDA tensors ``layer_norm`` launches the kernel in
``csrc/layer_norm.cu``: one launch a call, bf16 or fp32 in and out, which
reads each element once and writes it once. It replaces no TPU kernel (the
JAX package leaves LayerNorm to XLA): it was added because torch's route
(``x.float()``, ``F.layer_norm``, ``.to(dtype)``) runs three passes and gives
each row a thread block, which at the generator's rows of 2 to 384 values
left that route at under 1 % of its byte bound and at ~60 % of a serving
request's device time. For CPU tensors it runs its plain version, that
route. Forward only: ``models/layers.py`` sends a call here only when
autograd records nothing (``kernel_route``), and keeps torch's route, and
its backward, for the others. Each launch adds one to ``layer_norm.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .build import load
from .lookback import current_stream

_IO_DTYPES = (torch.float32, torch.bfloat16)

# The kernel's geometry (csrc/layer_norm.cu): 256 threads a CTA, at most 8
# CTAs an SM striding over the rows; a lane holds V of these vectors a chunk.
THREADS = 256
CTAS_PER_SM = 8
VECTORS = (1, 2, 3, 4, 6, 8)
H100_SMS = 132


class LayerNormPlan(NamedTuple):
    vec: int           # E: values a vector load carries (E · itemsize ≤ 16 bytes)
    vectors: int       # V: vectors a lane holds a chunk
    rows_per_vec: int  # P: whole rows packed into one vector (then V = lanes = 1)
    lanes: int         # G: lanes a row, a power of two up to a warp
    chunks: int        # passes of G · V vectors that walk one row
    threads: int       # a CTA
    blocks: int        # the grid, which strides over the rows


def _instances():
    """(in dtype, out dtype, E, V, P) of every kernel instance, as
    csrc/layer_norm.cu's by_width dispatches them."""
    for tin, full in (("__nv_bfloat16", 8), ("float", 4)):
        for tout in ("__nv_bfloat16", "float"):
            e = 1
            while e <= full:
                for v in VECTORS:
                    yield tin, tout, e, v, 1
                e *= 2
            p = 2
            while p <= full:
                yield tin, tout, full, 1, p
                p *= 2


# The device kernel one launch runs, under the names torch.profiler gives it
# (demangled), one for each instance.
_NS = "vmasr_norm::(anonymous namespace)::"
LAYER_NORM_KERNELS = {
    "norm": tuple(f"void {_NS}layer_norm_kernel<{tin}, {tout}, {e}, {v}, {p}>({_NS}LnArgs)"
                  for tin, tout, e, v, p in _instances()),
}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def layer_norm_plan(rows: int, n: int, itemsize: int, align: int = 16,
                    sms: int = H100_SMS) -> LayerNormPlan:
    """The kernel's geometry for ``rows`` rows of ``n`` values of
    ``itemsize`` bytes, the input aligned to ``align`` bytes, on a card of
    ``sms`` SMs. E: the widest vector of at most 16 bytes that divides the
    row and its alignment; a row narrower than a 16-byte vector, n a power
    of two, is packed whole with others into one (P = E / n). Wider rows:
    G, the largest power of two up to 32 that divides the row's vectors,
    raised until a lane holds at most 8; V, a lane's vectors rounded up to
    an instance (1, 2, 3, 4, 6, 8); rows wider than 32 · 8 vectors are
    walked in the fewest chunks, V the fewest vectors that cover them."""
    if rows < 1 or n < 1:
        raise ValueError(f"rows = {rows}, N = {n}: both must be positive")
    if itemsize not in (2, 4):
        raise ValueError(f"the kernel takes bf16 or fp32, not {itemsize}-byte items")
    full = 16 // itemsize
    if align >= 16 and n < full and full % n == 0:
        e, v, p, g, chunks = full, 1, full // n, 1, 1
    else:
        e = full
        while e > 1 and (n % e or e * itemsize > align):
            e //= 2
        vecs = n // e
        g = 1
        while g < 32 and vecs % (2 * g) == 0:
            g *= 2
        while g < 32 and _ceil(vecs, g) > VECTORS[-1]:
            g *= 2
        chunks, p = _ceil(vecs, g * VECTORS[-1]), 1
        v = next(k for k in VECTORS if k >= _ceil(vecs, g * chunks))
    blocks = min(_ceil(_ceil(rows, p) * g, THREADS), sms * CTAS_PER_SM)
    return LayerNormPlan(e, v, p, g, chunks, THREADS, blocks)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's plain version: torch's route, ``models/layers.py``'s
    expression before the kernel."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps).to(out_dtype)


def kernel_route(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 out_dtype: torch.dtype) -> bool:
    """Whether a LayerNorm call takes the kernel, from what the call shows:
    CUDA, bf16 or fp32 in and out with fp32 parameters, autograd recording
    nothing (no gradient enabled, or no input that needs one), and not under
    ``torch.func.vmap`` (the stacked generator; the kernel has no vmap rule)."""
    return (x.is_cuda and x.dtype in _IO_DTYPES and out_dtype in _IO_DTYPES
            and weight.dtype == torch.float32 and bias.dtype == torch.float32
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (x, weight, bias)))
            and not torch._C._functorch.is_batchedtensor(x))


@functools.cache
def _kernel():
    fn = load("layer_norm.cu").vmasr_layer_norm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(x, weight, bias, out_dtype):
    n = x.shape[-1] if x.dim() else 0
    if any(t.device != x.device for t in (weight, bias)):
        raise ValueError("x, weight and bias must be on one CUDA device")
    if weight.shape != (n,) or bias.shape != (n,):
        raise ValueError(f"weight, bias must be ({n},), got {tuple(weight.shape)}, "
                         f"{tuple(bias.shape)}")
    if x.dtype not in _IO_DTYPES or out_dtype not in _IO_DTYPES:
        raise TypeError(f"x and the output must be float32 or bfloat16, got {x.dtype}, "
                        f"{out_dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("weight and bias must be float32")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (weight, bias)):
        raise ValueError("the kernel takes contiguous, 16-byte aligned weight and bias "
                         "(a parameter's own storage is)")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               out_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm of x over its last dimension, forward only (no autograd).
    Returns x's shape in ``out_dtype``, contiguous.

    Args:
      x:            (..., N), float32 or bfloat16, any strides (copied to
                    contiguous rows when it is not)
      weight, bias: (N,) float32
      out_dtype:    float32 or bfloat16
    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes these dtypes at any N, and nothing else."""
    if all(t.device.type == "cpu" for t in (x, weight, bias)):
        return layer_norm_plain(x, weight, bias, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"expected CUDA or CPU tensors, got {x.device}")
    _check(x, weight, bias, out_dtype)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    x = x.contiguous()
    n = x.shape[-1]
    rows = x.numel() // n
    ptr = x.data_ptr()
    plan = layer_norm_plan(rows, n, x.element_size(), min(16, ptr & -ptr),
                           _sms(x.device.index if x.device.index is not None
                                else torch.cuda.current_device()))
    err = _kernel()(ptr, weight.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, n,
                    int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), eps,
                    *plan, current_stream(x.device))
    if err:
        raise RuntimeError(f"layer_norm kernel launch failed: cudaError {err}")
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
