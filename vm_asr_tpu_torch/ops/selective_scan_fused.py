"""Fused N=1 selective scan, forward and backward, in (B, L, K·D) layout.

Port of vm_asr_tpu/ops/selective_scan_fused.py:

    dt = softplus(dts + bias);  a = exp(dt·A);  b = dt·u·B_k
    h  = scan(a, b);            y = C_k·h + D_skip·u

with channel q = k·D + d and B, C given per direction k.
``selective_scan_fused`` is differentiable (the JAX package's
``custom_vjp``): an autograd Function, or inside an activation checkpoint the
dispatcher op ``torch.ops.vmasr.fused_scan``, whose outputs the checkpoint
can keep. For CUDA tensors its forward launches the kernel in
``csrc/fused_scan.cu`` (the counterpart of the TPU kernel
``_fused_fwd_pallas``, one launch per call) and keeps the chunk-entry states
``H0`` and the chunk length; its backward launches the kernel in
``csrc/fused_scan_bwd.cu`` (the counterpart of ``_fused_bwd_pallas``), which
rebuilds h from them. For CPU tensors both directions run their plain
versions, and the plain backward ignores ``H0``. Each launch adds one to
``selective_scan_fused.launches`` or ``selective_scan_fused_bwd.launches``.

Under ``torch.func.vmap`` (the stream-stacked generator,
models/unet.py:DualStreamStackedMambaUNet) the scan keeps one launch: the
vmapped axis S folds into the rows, (S·B, L, K·D), and A, dt_bias and
D_skip become S parameter sets (S, K·D) that the kernel reads per run of B
rows, as ``pallas_call``'s batching rule runs ``_fused_fwd_pallas`` under
the JAX package's ``nn.vmap``. That route serves only: a vmapped call that
needs a gradient raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .build import load
from .lookback import current_stream, lookback_smem, lookback_work_bytes, lookback_workspace
from .selective_scan_ref import linear_recurrence_ref, softplus

_IO_DTYPES = (torch.float32, torch.bfloat16)

# Threads the chunked kernels aim to start: about one full load of the
# card's 132 SMs × 2048 resident threads.
_TARGET_THREADS = 1 << 18
_MIN_CHUNK, _MAX_CHUNK = 16, 1024


def chunk_length(rows: int, length: int, channels: int) -> int:
    """L-chunk of the fused kernels: the power of two (16..1024) that gives
    each of about ``_TARGET_THREADS`` threads one chunk of one channel."""
    want = -(-rows * length * channels // _TARGET_THREADS)
    chunk = _MIN_CHUNK
    while chunk < want and chunk < _MAX_CHUNK:
        chunk *= 2
    return chunk


# The device kernels one launch of each wrapper runs, by pass, under the
# names torch.profiler gives them (demangled), for bf16 and fp32 IO. The
# forward is one kernel, compiled for 32-channel groups and for any group,
# and needs nothing to initialise it (its look-back words carry a per-call
# epoch, which the kernel keeps in the workspace). The backward's fold takes
# two bf16 channels per 4-byte load where the rows allow, else one channel
# per thread; its carry pass
# (csrc/fused_scan_bwd.cu:chunk_carry_kernel) is the only chunk-carry kernel
# left in the port.
_NS = "vmasr::(anonymous namespace)::"
_TYPES = ("__nv_bfloat16", "float")
CARRY_KERNEL = "vmasr::chunk_carry_kernel(float const*, float const*, float*, int)"
FWD_KERNELS = {
    "scan": tuple(f"void {_NS}fused_fwd_kernel<{t}, {g}>({_NS}FwdArgs, {_NS}FwdTile, "
                  "vmasr::LookBack)" for t in _TYPES for g in (32, 0)),
}
BWD_KERNELS = {
    "fold": tuple(f"void {_NS}bwd_fold_kernel<{t}, {v}>({_NS}BwdArgs, float*, float*)"
                  for t, v in (("__nv_bfloat16", 2), ("__nv_bfloat16", 1), ("float", 1))),
    "carry": (CARRY_KERNEL,),
    "tile": tuple(f"void {_NS}bwd_tile_kernel<{t}>({_NS}BwdArgs, {_NS}Tile, float const*, "
                  "float*, float*)" for t in _TYPES),
    "reduce": (f"{_NS}reduce_rows_kernel(float const*, float*, int, int)",),
}


def _plain_states(u, dts, bs, a_neg, dt_bias, k_group: int):
    """h of every step and u in the plain versions' maths dtype (fp32, or
    fp64 for fp64 inputs)."""
    d_inner = u.shape[-1] // k_group
    uf, dts, bs, a_neg, dt_bias = (t.to(torch.promote_types(u.dtype, torch.float32))
                                   for t in (u, dts, bs, a_neg, dt_bias))
    dt = softplus(dts + dt_bias)
    a = torch.exp(dt * a_neg)
    return linear_recurrence_ref(a, (dt * uf) * bs.repeat_interleave(d_inner, dim=-1),
                                 dim=-2), uf


def _by_group(fn):
    """``fn`` over S parameter sets: A, dt_bias and D_skip of shape (S, K·D)
    apply to runs of B / S rows each (the kernel's parameter groups)."""
    @functools.wraps(fn)
    def grouped(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group, *args):
        if a_neg.dim() == 1:
            return fn(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group, *args)
        s = a_neg.shape[0]
        rows = lambda t: t.reshape(s, t.shape[0] // s, *t.shape[1:])  # noqa: E731
        sets = lambda p: p[:, None, None]  # noqa: E731
        out = fn(rows(u), rows(dts), rows(bs), rows(cs), sets(a_neg), sets(dt_bias),
                 sets(d_skip), k_group, *args)
        return out.reshape(-1, *out.shape[2:])
    return grouped


@_by_group
def selective_scan_fused_plain(u, dts, bs, cs, a_neg, dt_bias, d_skip,
                               k_group: int) -> torch.Tensor:
    """The forward kernel's plain version: the same fp32 maths in torch ops
    (fp64 maths for fp64 inputs). A, dt_bias and D_skip are (K·D,), or
    (S, K·D) parameter sets, each for a run of B / S rows."""
    h, uf = _plain_states(u, dts, bs, a_neg, dt_bias, k_group)
    c_lanes = cs.to(h.dtype).repeat_interleave(u.shape[-1] // k_group, dim=-1)
    return (c_lanes * h + d_skip.to(h.dtype) * uf).to(u.dtype)


@_by_group
def fused_chunk_states_plain(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group: int,
                             chunk: int) -> torch.Tensor:
    """The plain version of the forward kernel's H0: the state entering each
    L-chunk of ``chunk`` steps, (B, ceil(L / chunk), K·D) in fp32 (fp64 for
    fp64 inputs); 0 for the first chunk. ``cs`` and ``d_skip`` take no part
    in it; they are taken so that the call matches the kernel's."""
    h, _ = _plain_states(u, dts, bs, a_neg, dt_bias, k_group)
    n_chunks = -(-u.shape[-2] // chunk)
    steps = h[..., chunk - 1::chunk, :][..., :n_chunks - 1, :]
    return torch.cat([torch.zeros_like(h[..., :1, :]), steps], dim=-2)


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


@functools.cache
def _fwd_kernel():
    fn = load("fused_scan.cu").vmasr_fused_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] + [ctypes.c_int] * 14
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = load("fused_scan_bwd.cu").vmasr_fused_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# Pass 3 of the backward kernel (csrc/fused_scan_bwd.cu) runs one thread per
# channel of a CTA's channel group and stages S steps of the group in shared
# memory. H100: 228 KB of shared memory per SM, 1 KB of it reserved per CTA,
# at most 232 448 bytes for one CTA.
SM_SMEM_BYTES = 233_472
CTA_RESERVED_BYTES = 1_024
BLOCK_SMEM_MAX = 232_448
_MIN_GROUP = 128        # channels per CTA: rows of >= 256 bytes in bf16
_MAX_STEPS = 16         # measured faster than 32 at (4, 16384, 128) on an H100
_MIN_CTAS_PER_SM = 2
_MAX_TILE_THREADS = 512
_BATCH = 4              # the kernel's steps per batch (kBatch)


def _r16(n: int) -> int:
    return -(-n // 16) * 16


class TileLayout(NamedTuple):
    channels: int    # per CTA: a whole number of directions
    threads: int     # per CTA: one per channel, rounded up to a warp
    steps: int       # per sub-tile
    smem_bytes: int  # dynamic shared memory per CTA


def bwd_tile_smem(channels: int, steps: int, k_group: int, itemsize: int) -> int:
    """Shared memory of one pass-3 CTA (csrc/fused_scan_bwd.cu:smem_bytes),
    for ``rows`` = ``steps`` rounded up to the kernel's batch of 4: h_{t-1},
    dt, a, sigmoid in fp32 for ``channels`` × (``rows`` + 1), and the staging
    buffer of u, dts, dy (``rows`` × ``channels``) and B, C (``rows`` ×
    ``k_group``) in the IO dtype, each array rounded up to 16 bytes."""
    rows = -(-steps // _BATCH) * _BATCH
    buf = 3 * _r16(rows * channels * itemsize) + 2 * _r16(rows * k_group * itemsize)
    return 16 * channels * (rows + 1) + buf


@functools.lru_cache(maxsize=None)
def bwd_tile_layout(kd: int, k_group: int, chunk: int, itemsize: int) -> TileLayout:
    """Geometry of the backward kernel's pass 3 for (B, L, ``kd``) inputs of
    ``itemsize`` bytes in L-chunks of ``chunk``. A CTA takes the fewest whole
    directions that make at least 128 channels (one direction when D >= 128),
    and the most steps (up to 16, and up to the chunk) that let two CTAs share
    an SM's shared memory, or one batch of the kernel's steps where none do
    (D = 512 in fp32)."""
    if k_group <= 0 or kd % k_group:
        raise ValueError(f"K·D = {kd} is not a multiple of K = {k_group}")
    d = kd // k_group
    n_dir = next((m for m in range(1, k_group + 1)
                  if k_group % m == 0 and m * d >= _MIN_GROUP), k_group)
    channels = n_dir * d
    threads = -(-channels // 32) * 32
    if threads > _MAX_TILE_THREADS:
        raise ValueError(f"the backward kernel takes D <= {_MAX_TILE_THREADS}, got D = {d}")
    steps = min(chunk, _MAX_STEPS)
    fits = lambda s: _MIN_CTAS_PER_SM * (bwd_tile_smem(channels, s, k_group, itemsize)  # noqa: E731
                                         + CTA_RESERVED_BYTES) <= SM_SMEM_BYTES
    while steps > _BATCH and not fits(steps):  # the tile holds whole batches anyway
        steps //= 2
    smem = bwd_tile_smem(channels, steps, k_group, itemsize)
    if smem > BLOCK_SMEM_MAX:
        raise ValueError(f"the backward kernel's tile for D = {d} needs {smem} bytes of shared "
                         f"memory, above {BLOCK_SMEM_MAX}")
    return TileLayout(channels, threads, steps, smem)


# The forward kernel (csrc/fused_scan.cu) walks tiles of (row, L-tile of
# whole chunks, channel group), one thread per (16-step segment of a chunk,
# channel), staged in shared memory; a thread keeps a and dt·u·B of its
# segment's steps in registers. 32-channel groups were the fastest on an
# H100 (more chains of tiles, shorter look-backs), and the kernel has an
# instance compiled for them.
_FWD_GROUP = 32           # channels per CTA where K·D is a multiple of it
_FWD_MAX_THREADS = 256    # the kernel's __launch_bounds__
_FWD_STEPS = 16           # the kernel's kSteps
_FWD_WINDOW = 16          # the look-back's checkpoint spacing W


class FwdTileLayout(NamedTuple):
    channels: int    # per CTA: a divisor of K·D
    chunks: int      # per CTA: the L-tile, in whole chunks
    splits: int      # segments per chunk, each a whole number of 16 steps
    threads: int     # channels × chunks × splits, rounded up to a warp
    window: int      # the look-back's checkpoint spacing W
    smem_bytes: int  # dynamic shared memory per CTA: staging and look-back


def fwd_tile_smem(channels: int, segments: int, k_group: int, itemsize: int) -> int:
    """Shared memory of one forward CTA (csrc/fused_scan.cu:smem_bytes): two
    buffers, each of u and dts for ``segments`` × 16 rows of ``channels`` and
    B and C for as many rows of ``k_group``, in the IO dtype, each array
    rounded up to 16 bytes."""
    rows = segments * _FWD_STEPS
    return 2 * (2 * _r16(rows * channels * itemsize) + 2 * _r16(rows * k_group * itemsize))


@functools.lru_cache(maxsize=None)
def fwd_tile_layout(kd: int, k_group: int, chunk: int, itemsize: int,
                    window: int = _FWD_WINDOW) -> FwdTileLayout:
    """Geometry of the forward kernel for (B, L, ``kd``) inputs of
    ``itemsize`` bytes in L-chunks of ``chunk`` steps (16 to 1024, a multiple
    of 16). A tile takes 32 channels where K·D is a multiple of 32 (the
    flagship's stages), else the largest divisor of K·D up to 256; each chunk
    goes to as many 16-step segments (threads per channel) as 256 threads
    hold, so that at 32 channels a thread walks one 16-step sub-tile of
    every chunk of up to 256 steps; and a tile takes as many chunks as fit
    in 256 threads. ``window`` is the look-back's W."""
    if k_group <= 0 or kd % k_group:
        raise ValueError(f"K·D = {kd} is not a multiple of K = {k_group}")
    if itemsize not in (2, 4):
        raise ValueError(f"the forward kernel takes bf16 or fp32, not {itemsize}-byte items")
    if not (_MIN_CHUNK <= chunk <= _MAX_CHUNK and chunk % _FWD_STEPS == 0):
        raise ValueError(f"the forward kernel takes chunks of {_MIN_CHUNK} to {_MAX_CHUNK} "
                         f"steps in multiples of {_FWD_STEPS}, got {chunk}")
    channels = _FWD_GROUP if kd % _FWD_GROUP == 0 else max(
        g for g in range(1, min(kd, _FWD_MAX_THREADS) + 1) if kd % g == 0)
    sub_tiles = chunk // _FWD_STEPS
    cap = max(1, _FWD_MAX_THREADS // channels)
    splits = max(s for s in range(1, min(sub_tiles, cap) + 1) if sub_tiles % s == 0)
    chunks = max(1, _FWD_MAX_THREADS // (channels * splits))
    threads = -(-channels * chunks * splits // 32) * 32
    if window < 1:
        raise ValueError(f"the look-back's window must be >= 1, got {window}")
    return FwdTileLayout(channels, chunks, splits, threads, window,
                         fwd_tile_smem(channels, chunks * splits, k_group, itemsize)
                         + lookback_smem(channels, window))


def fwd_workspace_bytes(bsz: int, l: int, kd: int, chunk: int, tile: FwdTileLayout) -> int:
    """Bytes of the forward kernel's look-back workspace: per (row, channel
    group, L-tile) and channel, the tile's (P, S) and its inclusive prefix,
    8 bytes each (the value and its tag)."""
    n_chunks = -(-l // chunk)
    slots = bsz * (kd // tile.channels) * -(-n_chunks // tile.chunks)
    return lookback_work_bytes(slots, tile.channels)


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
    sets = a_neg.shape[0] if a_neg.dim() == 2 else 1
    if any(p.shape != a_neg.shape for p in (dt_bias, d_skip)) or \
            a_neg.shape[-1:] != (kd,) or a_neg.dim() > 2 or bsz % sets:
        raise ValueError(f"A, dt_bias, D_skip must be ({kd},) or (S, {kd}) with S dividing "
                         f"B = {bsz}, got {[tuple(p.shape) for p in (a_neg, dt_bias, d_skip)]}")
    if u.dtype not in _IO_DTYPES or any(t.dtype != u.dtype for t in (dts, bs, cs)):
        raise TypeError("u, dts, bs, cs must share one dtype, float32 or bfloat16")
    if any(p.dtype != torch.float32 for p in (a_neg, dt_bias, d_skip)):
        raise TypeError("A, dt_bias, D_skip must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def selective_scan_fused_fwd(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group: int, *,
                             max_ctas: int = 0, window: int = _FWD_WINDOW):
    """Launch the forward kernel on CUDA tensors. Returns (y, H0, chunk): y
    (B, L, K·D) in u's dtype, H0 (B, n_chunks, K·D) fp32 the state entering
    each L-chunk of length ``chunk``. A, dt_bias and D_skip are (K·D,), or S
    parameter sets (S, K·D), set s serving rows s·B/S .. (s+1)·B/S − 1.
    ``max_ctas`` > 0 caps the persistent grid and ``window`` sets the
    look-back's W: checks that the result does not depend on them."""
    if u.device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {u.device}")
    _check(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group)
    bsz, l, kd = u.shape
    chunk = chunk_length(bsz, l, kd)
    tile = fwd_tile_layout(kd, k_group, chunk, u.element_size(), window)
    y = torch.empty_like(u)
    h0 = torch.empty((bsz, -(-l // chunk), kd), dtype=torch.float32, device=u.device)
    stream = current_stream(u.device)
    work = lookback_workspace(u.device, stream, fwd_workspace_bytes(bsz, l, kd, chunk, tile))
    err = _fwd_kernel()(u.data_ptr(), dts.data_ptr(), bs.data_ptr(), cs.data_ptr(),
                        a_neg.data_ptr(), dt_bias.data_ptr(), d_skip.data_ptr(),
                        y.data_ptr(), h0.data_ptr(), work.data_ptr(), work.numel(),
                        bsz, l, kd, k_group, chunk, bsz // (a_neg.numel() // kd),
                        int(u.dtype == torch.bfloat16), *tile, max_ctas, stream)
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
    if a_neg.dim() != 1:
        raise ValueError("the backward takes one parameter set: A, dt_bias, D_skip (K·D,)")
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
    tile = bwd_tile_layout(kd, k_group, chunk, u.element_size())
    n_sub = -(-chunk // tile.steps)
    # Planes of B·n_chunks·K·D floats: P and S (later the dA and dbias
    # partials), the dD partials, G, and h at the sub-tile starts of chunks
    # longer than a sub-tile.
    planes = 4 + (n_sub if n_sub > 1 else 0)
    du, ddts = torch.empty_like(u), torch.empty_like(dts)
    dbs, dcs = torch.empty((2, bsz, l, k_group), dtype=u.dtype, device=u.device)
    work = torch.empty(3 * kd + planes * bsz * n_chunks * kd, dtype=torch.float32,
                       device=u.device)  # dA, dbias, dD, then the planes
    err = _bwd_kernel()(
        u.data_ptr(), dts.data_ptr(), bs.data_ptr(), cs.data_ptr(), dy.data_ptr(),
        a_neg.data_ptr(), dt_bias.data_ptr(), d_skip.data_ptr(), h0.data_ptr(),
        du.data_ptr(), ddts.data_ptr(), dbs.data_ptr(), dcs.data_ptr(),
        work.data_ptr(), work[3 * kd:].data_ptr(),
        bsz, l, kd, k_group, chunk, int(u.dtype == torch.bfloat16), *tile,
        current_stream(u.device))
    if err:
        raise RuntimeError(f"selective_scan_fused_bwd kernel launch failed: cudaError {err}")
    selective_scan_fused_bwd.launches += 1
    return (du, ddts, dbs, dcs, work[:kd], work[kd:2 * kd], work[2 * kd:3 * kd])


def _fused_forward(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group):
    """(y, H0): the kernel for CUDA tensors, the plain version and an empty
    H0 for CPU tensors."""
    if _on_cpu(u, dts, bs, cs, a_neg, dt_bias, d_skip):
        return (selective_scan_fused_plain(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group),
                u.new_empty(0, dtype=torch.float32))
    y, h0, _ = selective_scan_fused_fwd(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group)
    return y, h0


def _fused_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:7], output[1])
    ctx.mark_non_differentiable(output[1])
    ctx.k_group = inputs[7]


def _fused_backward(ctx, dy, _dh0=None):
    u, dts, bs, cs, a_neg, dt_bias, d_skip, h0 = ctx.saved_tensors
    grads = selective_scan_fused_bwd(
        u, dts, bs, cs, dy.to(u.dtype).contiguous(), a_neg, dt_bias, d_skip, h0,
        chunk_length(*u.shape), ctx.k_group)
    return (*grads, None)


def serve_only(name: str, tensors) -> None:
    """Raise if a vmapped scan call needs a gradient: its rule launches the
    forward alone (the stacked generator serves only, as in the JAX
    package)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} under torch.func.vmap serves only and has no gradient; "
                           "run it under torch.no_grad() or torch.inference_mode()")


def fold_vmapped(t, bdim, n: int) -> torch.Tensor:
    """A vmapped tensor with its vmapped axis (``bdim``, or None: the same
    tensor for every entry) made the outermost, size ``n``, contiguous."""
    t = t.expand(n, *t.shape) if bdim is None else t.movedim(bdim, 0)
    return t.contiguous()


def _fused_vmap(info, in_dims, u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group):
    """The batching rule: one call over (S·B, L, K·D) rows with S parameter
    sets; returns (y, H0) with the vmapped axis first."""
    serve_only("selective_scan_fused", (u, dts, bs, cs, a_neg, dt_bias, d_skip))
    n = info.batch_size
    rows = [fold_vmapped(t, d, n) for t, d in zip((u, dts, bs, cs), in_dims)]
    sets = [fold_vmapped(t, d, n) for t, d in zip((a_neg, dt_bias, d_skip), in_dims[4:7])]
    y, h0 = _fused_forward(*(r.reshape(-1, *r.shape[2:]) for r in rows), *sets, k_group)
    return (y.reshape(n, -1, *y.shape[1:]), h0.reshape(n, -1, *h0.shape[1:])), (0, 0)


class _FusedScan(torch.autograd.Function):
    """The route of a scan outside an activation checkpoint: an autograd
    Function costs the host less per call than the dispatcher op below.
    Returns (y, H0); H0 carries no gradient."""

    @staticmethod
    def forward(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group):
        return _fused_forward(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group)

    setup_context = staticmethod(_fused_setup)
    backward = staticmethod(_fused_backward)
    vmap = staticmethod(_fused_vmap)


@torch.library.custom_op(
    "vmasr::fused_scan", mutates_args=(),
    schema="(Tensor u, Tensor dts, Tensor bs, Tensor cs, Tensor a_neg, Tensor dt_bias, "
           "Tensor d_skip, int k_group) -> (Tensor, Tensor)")
def fused_scan_op(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group):
    """The same forward as one dispatcher op returning (y, H0), whose outputs
    a selective activation checkpoint can name and keep (models/vss.py)."""
    return _fused_forward(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group)


@fused_scan_op.register_fake
def _(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group):
    if u.device.type == "cpu":
        return torch.empty_like(u), u.new_empty(0, dtype=torch.float32)
    bsz, l, kd = u.shape
    chunk = chunk_length(bsz, l, kd)
    return torch.empty_like(u), u.new_empty((bsz, -(-l // chunk), kd), dtype=torch.float32)


fused_scan_op.register_autograd(_fused_backward, setup_context=_fused_setup)
fused_scan_op.register_vmap(_fused_vmap)


def selective_scan_fused(u, dts, bs, cs, a_neg, dt_bias, d_skip,
                         k_group: int, as_op: bool = False) -> torch.Tensor:
    """Fused N=1 selective scan, differentiable in its seven tensor inputs.
    Returns y: (B, L, K·D) in u's dtype.

    Args:
      u, dts:  (B, L, K·D), float32 or bfloat16, channel q = k·D + d
      bs, cs:  (B, L, K), u's dtype
      a_neg:   (K·D,) float32, A = -exp(A_logs)
      dt_bias: (K·D,) float32
      d_skip:  (K·D,) float32
      as_op:   run as the dispatcher op ``torch.ops.vmasr.fused_scan``, which
               an activation checkpoint can keep; else an autograd Function.
    CPU tensors take the plain versions; CUDA tensors launch the kernels,
    which take contiguous tensors of these shapes and dtypes and nothing
    else. Under ``torch.func.vmap`` both routes take one launch over the
    vmapped axis folded into the rows, forward only."""
    if not _on_cpu(u, dts, bs, cs, a_neg, dt_bias, d_skip) and u.device.type != "cuda":
        raise ValueError(f"expected CUDA or CPU tensors, got {u.device}")
    if as_op:
        return torch.ops.vmasr.fused_scan(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group)[0]
    return _FusedScan.apply(u, dts, bs, cs, a_neg, dt_bias, d_skip, k_group)[0]


selective_scan_fused.launches = 0
selective_scan_fused_bwd.launches = 0
