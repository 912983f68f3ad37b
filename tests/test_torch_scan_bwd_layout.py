"""Launch geometry of the fused-scan backward kernel's pass 3, on the CPU.

``bwd_tile_layout`` decides how csrc/fused_scan_bwd.cu splits (B, L, K·D)
into CTAs: channels, threads, steps per sub-tile and dynamic shared memory.
The kernel runs only on the card; its geometry is plain Python and is held
here to what the kernel and an H100 take."""

import pytest

from vm_asr_tpu_torch.ops.selective_scan_fused import (
    BLOCK_SMEM_MAX,
    CTA_RESERVED_BYTES,
    SM_SMEM_BYTES,
    bwd_tile_layout,
    bwd_tile_smem,
)

K = 4
# (D, chunk) of the flagship's fused-scan calls at batch 4: (L, K·D) =
# (16384, 128), (4096, 256), (1024, 512), (256, 1024).
FLAGSHIP = {(32, 32), (64, 16), (128, 16), (256, 16)}


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("chunk", [16, 32, 64, 1024])
@pytest.mark.parametrize("d", [32, 48, 64, 96, 128, 192, 256, 384])
def test_bwd_tile_layout(d, chunk, itemsize):
    kd = K * d
    tile = bwd_tile_layout(kd, K, chunk, itemsize)
    # Every channel falls in exactly one CTA: the groups tile [0, K·D).
    assert kd % tile.channels == 0
    starts = range(0, kd, tile.channels)
    assert sorted(q for c0 in starts for q in range(c0, c0 + tile.channels)) == list(range(kd))
    # Whole directions, or exactly one where D >= 128.
    n_dir = tile.channels // d
    assert tile.channels == n_dir * d and K % n_dir == 0
    if d >= 128:
        assert n_dir == 1
    else:
        assert tile.channels >= 128 or n_dir == K
    # One thread per channel, whole warps.
    assert tile.channels <= tile.threads <= 1024 and tile.threads % 32 == 0
    assert tile.threads - tile.channels < 32
    assert 1 <= tile.steps <= chunk
    assert tile.smem_bytes == bwd_tile_smem(tile.channels, tile.steps, K, itemsize)
    assert tile.smem_bytes <= BLOCK_SMEM_MAX
    # At least two CTAs per SM by shared memory.
    assert 2 * (tile.smem_bytes + CTA_RESERVED_BYTES) <= SM_SMEM_BYTES
    # The flagship train step's chunks take at most two sub-tiles each.
    if (d, chunk) in FLAGSHIP:
        assert -(-chunk // tile.steps) <= 2


def test_bwd_tile_layout_refuses_wide_directions():
    """One thread per channel of one direction: D > 512 is refused on the
    host, before any launch."""
    with pytest.raises(ValueError, match="D <= 512"):
        bwd_tile_layout(K * 1024, K, 16, 2)
