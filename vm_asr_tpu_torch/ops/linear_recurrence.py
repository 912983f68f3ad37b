"""First-order linear recurrence ``h_t = a_t * h_{t-1} + b_t`` over (R, L, D).

Port of vm_asr_tpu/ops/linear_recurrence.py. ``linear_recurrence`` is
differentiable (the JAX package's ``custom_vjp``): an autograd Function, or
inside an activation checkpoint the dispatcher op
``torch.ops.vmasr.linear_recurrence``, whose output the checkpoint can keep.
For CUDA
tensors its forward launches the kernel in ``csrc/linear_recurrence.cu`` (the
counterpart of the TPU kernel ``_lr_pallas``), and its backward launches the
same kernel in reverse (``linear_recurrence_reverse``, the counterpart of
``_lr_bwd``). For CPU tensors both directions run their plain versions. Each
forward launch adds one to ``linear_recurrence.launches``, each reverse launch
one to ``linear_recurrence_reverse.launches``. Under ``torch.func.vmap`` the
vmapped axis folds into the rows, one launch for all of them, forward only
(the stream-stacked generator serves only).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .build import load
from .lookback import current_stream, lookback_smem, lookback_work_bytes, lookback_workspace
from .selective_scan_fused import fold_vmapped, serve_only
from .selective_scan_ref import linear_recurrence_ref

# The device kernel one launch of each wrapper runs, under the names
# torch.profiler gives it (demangled): one pass, compiled for groups of 8
# and 32 channels and for any group, and nothing to initialise it (its
# look-back words carry a per-call epoch).
_NS = "vmasr::(anonymous namespace)::"


def _lr_kernel_names(reverse: bool) -> tuple:
    return tuple(f"void {_NS}lr_scan_kernel<{str(reverse).lower()}, {g}>({_NS}LrArgs, "
                 f"{_NS}LrTile, vmasr::LookBack)" for g in (8, 32, 0))


LR_KERNELS = {"scan": _lr_kernel_names(False)}
LR_REVERSE_KERNELS = {"scan": _lr_kernel_names(True)}

# The kernel (csrc/linear_recurrence.cu) walks tiles of (row, L-tile,
# channel group), one thread per (16-step segment, channel), staged in
# shared memory.
_LR_STEPS = 16          # the kernel's kSeg
_LR_MAX_THREADS = 256   # the kernel's kMaxThreads
_LR_MAX_GROUP = 64      # the kernel's kMaxGroup
_INT32_MAX = 2**31 - 1


class LrTileLayout(NamedTuple):
    channels: int    # per CTA: a divisor of D
    segments: int    # per tile, each of 16 steps, one thread per channel
    threads: int     # channels × segments, rounded up to a warp
    window: int      # the look-back's checkpoint spacing W
    smem_bytes: int  # dynamic shared memory per CTA


def _lr_window(channels: int, reverse: bool) -> int:
    """The look-back's W for groups of ``channels``: W·G near 1024 forward
    and 512 in reverse (a tile reads at most ~8 KB or ~4 KB of aggregates),
    within 8..64; the fastest of 8, 16, 32 and 64 at each flagship shape on
    an H100 but for ties within the spread (W = 32 forward at G = 32, 16 in
    reverse; 32 or 64 alike at G = 8)."""
    return max(8, min(64, (512 if reverse else 1024) // channels))


def lr_tile_smem(channels: int, segments: int, reverse: bool, window: int) -> int:
    """Shared memory of one CTA (csrc/linear_recurrence.cu:smem_bytes): two
    buffers of a and b (the reverse: a, g, h), each ``segments`` × 16 steps
    of ``channels`` fp32 with segments padded apart by ``channels`` floats
    where ``channels`` < 32 divides 32, and the look-back's words."""
    stride = _LR_STEPS * channels + (channels if channels < 32 and 32 % channels == 0 else 0)
    return 2 * (3 if reverse else 2) * segments * stride * 4 + lookback_smem(channels, window)


@functools.lru_cache(maxsize=None)
def lr_tile_layout(r: int, l: int, d: int, reverse: bool = False,
                   window: int | None = None) -> LrTileLayout:
    """Geometry of the recurrence kernel for (``r``, ``l``, ``d``) inputs,
    forward or ``reverse``. A tile takes 32 channels where D is a multiple of
    32, else the largest divisor of D up to 64, and as many 16-step segments
    as 256 threads hold; ``window`` overrides the look-back's W."""
    if min(r, l, d) <= 0:
        raise ValueError(f"the recurrence takes (R, L, D) with each > 0, got {(r, l, d)}")
    channels = 32 if d % 32 == 0 else max(
        g for g in range(1, min(d, _LR_MAX_GROUP) + 1) if d % g == 0)
    segments = _LR_MAX_THREADS // channels
    threads = -(-channels * segments // 32) * 32
    window = _lr_window(channels, reverse) if window is None else window
    if window < 1:
        raise ValueError(f"the look-back's window must be >= 1, got {window}")
    n_tiles = -(-l // (segments * _LR_STEPS))
    if r * (d // channels) * n_tiles > _INT32_MAX:
        raise ValueError(f"(R, L, D) = {(r, l, d)} has more tiles than int32 counts")
    return LrTileLayout(channels, segments, threads, window,
                        lr_tile_smem(channels, segments, reverse, window))


def lr_workspace_bytes(r: int, l: int, d: int, tile: LrTileLayout) -> int:
    """Bytes of the kernel's look-back workspace for (``r``, ``l``, ``d``)."""
    n_tiles = -(-l // (tile.segments * _LR_STEPS))
    return lookback_work_bytes(r * (d // tile.channels) * n_tiles, tile.channels)


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


@functools.cache
def _kernel(reverse: bool):
    lib = load("linear_recurrence.cu")
    fn = lib.vmasr_linear_recurrence_reverse if reverse else lib.vmasr_linear_recurrence
    fn.argtypes = ([ctypes.c_void_p] * (6 if reverse else 4) + [ctypes.c_int64, ctypes.c_uint32]
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
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


def _launch(reverse: bool, ptrs, shape, device, max_ctas: int, window: int | None):
    r, l, d = shape
    tile = lr_tile_layout(r, l, d, reverse, window)
    stream = current_stream(device)
    work, epoch = lookback_workspace(device, stream, lr_workspace_bytes(r, l, d, tile))
    err = _kernel(reverse)(*ptrs, work.data_ptr(), work.numel(), epoch, r, l, d, *tile,
                           max_ctas, stream)
    if err:
        name = "linear_recurrence_reverse" if reverse else "linear_recurrence"
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def linear_recurrence_fwd(a: torch.Tensor, b: torch.Tensor, *, max_ctas: int = 0,
                          window: int | None = None) -> torch.Tensor:
    """Launch the forward kernel on contiguous fp32 CUDA tensors (R, L, D).
    ``max_ctas`` > 0 caps the persistent grid and ``window`` sets the
    look-back's W: checks that the result does not depend on them."""
    _check(a, b)
    h = torch.empty_like(a)
    _launch(False, (a.data_ptr(), b.data_ptr(), h.data_ptr()), a.shape, a.device, max_ctas,
            window)
    linear_recurrence.launches += 1
    return h


def linear_recurrence_reverse(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor, *,
                              max_ctas: int = 0, window: int | None = None):
    """The recurrence's backward: given a, the forward's h and the gradient g
    of h, returns (da, db) with db_t = dh_t = g_t + a_{t+1}·dh_{t+1} and
    da_t = dh_t·h_{t-1}, fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel in
    reverse, on contiguous fp32 tensors of one shape and nothing else
    (``max_ctas`` and ``window`` as for ``linear_recurrence_fwd``)."""
    if all(t.device.type == "cpu" for t in (a, h, g)):
        return linear_recurrence_reverse_plain(a, h, g)
    _check(a, h, g)
    dh, da = torch.empty_like(a), torch.empty_like(a)
    _launch(True, (a.data_ptr(), g.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr()),
            a.shape, a.device, max_ctas, window)
    linear_recurrence_reverse.launches += 1
    return da, dh


def _lr_forward(a, b):
    if a.device.type == "cpu" and b.device.type == "cpu":
        h = linear_recurrence_plain(a, b)
        return h.clone() if h.data_ptr() == b.data_ptr() else h  # L = 1: h is b
    return linear_recurrence_fwd(a, b)


def _lr_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output)


def _lr_backward(ctx, g):
    a, h = ctx.saved_tensors
    da, db = linear_recurrence_reverse(a, h, g.float().contiguous())
    return da.to(a.dtype), db


def _lr_vmap(info, in_dims, a, b):
    """The batching rule: one call over the rows of every vmapped entry."""
    serve_only("linear_recurrence", (a, b))
    n = info.batch_size
    a, b = (fold_vmapped(t, d, n) for t, d in zip((a, b), in_dims))
    h = _lr_forward(a.reshape(-1, *a.shape[2:]), b.reshape(-1, *b.shape[2:]))
    return h.reshape(n, -1, *h.shape[1:]), 0


class _LinearRecurrence(torch.autograd.Function):
    """The route of a recurrence outside an activation checkpoint: an
    autograd Function costs the host less per call than the dispatcher op
    below."""

    @staticmethod
    def forward(a, b):
        return _lr_forward(a, b)

    setup_context = staticmethod(_lr_setup)
    backward = staticmethod(_lr_backward)
    vmap = staticmethod(_lr_vmap)


@torch.library.custom_op("vmasr::linear_recurrence", mutates_args=(),
                         schema="(Tensor a, Tensor b) -> Tensor")
def linear_recurrence_op(a, b):
    """The same forward as one dispatcher op, whose output a selective
    activation checkpoint can name and keep (models/vss.py)."""
    return _lr_forward(a, b)


@linear_recurrence_op.register_fake
def _(a, b):
    return torch.empty_like(a, dtype=torch.promote_types(a.dtype, torch.float32))


linear_recurrence_op.register_autograd(_lr_backward, setup_context=_lr_setup)
linear_recurrence_op.register_vmap(_lr_vmap)


def linear_recurrence(a: torch.Tensor, b: torch.Tensor, as_op: bool = False) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 of (R, L, D) fp32 tensors,
    differentiable in a and b. ``as_op``: run as the dispatcher op
    ``torch.ops.vmasr.linear_recurrence``, which an activation checkpoint can
    keep; else an autograd Function.

    CPU tensors take the plain versions; CUDA tensors launch the kernels,
    which take contiguous fp32 tensors of one shape on one device, and
    nothing else."""
    if not (a.device.type == "cpu" and b.device.type == "cpu") and a.device.type != "cuda":
        raise ValueError(f"a and b must be on one CUDA device, got {a.device}, {b.device}")
    if as_op:
        return torch.ops.vmasr.linear_recurrence(a, b)
    return _LinearRecurrence.apply(a, b)


linear_recurrence.launches = 0
linear_recurrence_reverse.launches = 0
