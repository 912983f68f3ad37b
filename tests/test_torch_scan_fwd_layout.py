"""The fused-scan forward kernel's chunk states and launch geometry, on the
CPU.

``fused_chunk_states_plain`` is the plain version of the kernel's H0 (the
state entering each L-chunk, which the backward rebuilds h from); it is held
here against ``ckpt`` of the JAX package's Pallas forward in interpret mode.
``fwd_tile_layout`` decides how csrc/fused_scan.cu splits (B, L, K·D) into
CTAs; the kernel runs only on the card, its geometry is plain Python and is
held here to what the kernel and an H100 take."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vm_asr_tpu.ops.selective_scan_fused import _fused_fwd_pallas
from vm_asr_tpu_torch.ops import fused_chunk_states_plain
from vm_asr_tpu_torch.ops.lookback import lookback_smem
from vm_asr_tpu_torch.ops.selective_scan_fused import (
    BLOCK_SMEM_MAX,
    chunk_length,
    fwd_tile_layout,
    fwd_tile_smem,
    fwd_workspace_bytes,
)

K = 4
# fp32 chunk states summed in another order (doubling scan vs the Pallas
# kernel's chunked scan): the bar of tests/test_fused_scan.py:29-30.
FP32_TOL = 1e-4
# (L, K·D) of the flagship forward's fused-scan calls (chip_smoke.FUSED_CALLS),
# at batch 1 (serving), 4 (training) and 8 (the largest segment bucket).
FLAGSHIP = ((16384, 128), (4096, 256), (1024, 512), (256, 1024))
INT32_MAX = 2**31 - 1


@pytest.mark.parametrize("b,l,d,chunk", [
    (2, 700, 32, 64),   # 11 chunks, the last one ragged
    (1, 300, 32, 128),  # L < 3 chunks, ragged
    (2, 250, 33, 64),   # D = 33: K·D = 132, padded to 256 lanes on the JAX side
    (1, 512, 48, 16),   # D = 48, many short chunks, L a whole number of them
])
def test_chunk_states_match_jax_ckpt(b, l, d, chunk):
    rng = np.random.default_rng(7)
    kd = K * d
    u = rng.standard_normal((b, l, kd)).astype(np.float32)
    dts = (0.5 * rng.standard_normal((b, l, kd))).astype(np.float32)
    bs = rng.standard_normal((b, l, K)).astype(np.float32)
    cs = rng.standard_normal((b, l, K)).astype(np.float32)
    a = (-np.exp(rng.uniform(-1, 1, kd))).astype(np.float32)
    bias = rng.uniform(-5, -2, kd).astype(np.float32)
    dsk = rng.standard_normal(kd).astype(np.float32)
    args = (u, dts, bs, cs, a, bias, dsk)
    _, ckpt = _fused_fwd_pallas(*map(jnp.asarray, args), K, chunk=chunk, interpret=True)
    ref = np.asarray(ckpt)[..., :kd]
    got = fused_chunk_states_plain(*map(torch.from_numpy, args), K, chunk)
    assert got.dtype == torch.float32 and got.shape == (b, -(-l // chunk), kd)
    np.testing.assert_allclose(got.numpy(), ref, rtol=FP32_TOL, atol=FP32_TOL)
    assert not got[:, 0].any()  # nothing enters the first chunk


def _check_layout(bsz, l, kd, chunk, itemsize):
    tile = fwd_tile_layout(kd, K, chunk, itemsize)
    # Channel groups tile [0, K·D); where K·D is a multiple of 32 (the
    # flagship's stages) a group is 32 channels, whose rows are whole 16-byte
    # pieces, and the kernel's instance for 32 channels takes it.
    assert kd % tile.channels == 0 and tile.channels <= 256
    if kd % 32 == 0:
        assert tile.channels == 32
    # An L-tile is a whole number of chunks, a chunk a whole number of
    # segments, and a segment a whole number of the kernel's 16-step sub-tiles.
    assert tile.chunks >= 1 and tile.splits >= 1
    assert chunk % (16 * tile.splits) == 0
    # One thread per (segment, channel), whole warps, within __launch_bounds__.
    segments = tile.chunks * tile.splits
    assert tile.channels * segments <= tile.threads <= 256 and tile.threads % 32 == 0
    assert tile.threads - tile.channels * segments < 32
    # Two staging buffers, then the look-back's words.
    assert tile.smem_bytes == (fwd_tile_smem(tile.channels, segments, K, itemsize)
                               + lookback_smem(tile.channels, tile.window))
    assert tile.smem_bytes <= BLOCK_SMEM_MAX
    # The grid, one CTA per look-back slot, and the workspace's slots fit int32.
    n_tiles = -(-(-(-l // chunk)) // tile.chunks)
    slots = bsz * (kd // tile.channels) * n_tiles
    assert slots <= INT32_MAX
    assert fwd_workspace_bytes(bsz, l, kd, chunk, tile) == 24 * slots * tile.channels + 256
    return tile


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("bsz", [1, 4, 8])
@pytest.mark.parametrize("l,kd", FLAGSHIP)
def test_fwd_tile_layout_flagship(l, kd, bsz, itemsize):
    chunk = chunk_length(bsz, l, kd)
    tile = _check_layout(bsz, l, kd, chunk, itemsize)
    if bsz <= 4:  # serving and training: a thread walks one 16-step sub-tile
        assert chunk == 16 * tile.splits


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("chunk", [16, 32, 64, 128, 1024])
@pytest.mark.parametrize("d", [33, 48])
def test_fwd_tile_layout_other_widths(d, chunk, itemsize):
    _check_layout(4, 16384, K * d, chunk, itemsize)


@pytest.mark.parametrize("kd,k_group,chunk,itemsize,match", [
    (130, 4, 32, 2, "not a multiple of K"),
    (128, 4, 8, 2, "chunks of 16 to 1024"),
    (128, 4, 2048, 2, "chunks of 16 to 1024"),
    (128, 4, 24, 2, "chunks of 16 to 1024"),
    (128, 4, 32, 8, "bf16 or fp32"),
])
def test_fwd_tile_layout_refuses(kd, k_group, chunk, itemsize, match):
    with pytest.raises(ValueError, match=match):
        fwd_tile_layout(kd, k_group, chunk, itemsize)
