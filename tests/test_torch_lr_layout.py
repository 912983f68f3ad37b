"""The linear-recurrence kernel's launch geometry and the look-back rule that
the one-launch scans share, on the CPU.

csrc/linear_recurrence.cu runs only on the card; how it cuts (R, L, D) into
CTAs is plain Python (``lr_tile_layout``), held here to what the kernel and
an H100 take. ``lookback_plan`` below mirrors csrc/scan_common.cuh's rule:
which checkpoint's state a tile starts from and which aggregates it
composes onto it. The tests check that every tile's entry state covers exactly the tiles
before it in its chain, each once, and that a walk of the rule in fp32 (the
kernel's tiles, segments and order of composition) gives the recurrence of
the JAX package, forward and in reverse. ``_cta`` mirrors the look-back's
epoch, which the kernels keep on the device (open_call, take_tile,
close_call): replays of captured calls, their CTAs interleaved at random,
read only their own words, across the epoch's wrap."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vm_asr_tpu.ops.linear_recurrence import linear_recurrence as jax_lr
from vm_asr_tpu_torch.ops import linear_recurrence_reverse_plain
from vm_asr_tpu_torch.ops.linear_recurrence import (
    lr_tile_layout,
    lr_tile_smem,
    lr_workspace_bytes,
)
from vm_asr_tpu_torch.ops.lookback import lookback_smem

# An H100: shared memory per SM, reserved per CTA, at most for one CTA.
SM_SMEM_BYTES = 233_472
CTA_RESERVED_BYTES = 1_024
BLOCK_SMEM_MAX = 232_448
STATIC_SMEM = 256 * 8 + 8  # the kernel's `part` (one affine step per thread), ticket and epoch
INT32_MAX = 2**31 - 1
STEPS = 16                 # the kernel's segment
FP32_TOL = 1e-4            # the bar of tests/test_fused_scan.py:29-30
# (L, D) of the flagship forward's recurrence calls (chip_smoke.LR_CALLS),
# at batch 1 (serving), 4 (training) and 8 (the largest segment bucket).
FLAGSHIP = ((65536, 64), (262144, 8))
# Off the main path: a ragged L over many tiles, and D = 1, 5, 33 (groups
# whose rows are no whole 16-byte pieces), D = 48 and 96.
OTHER = ((3, 100_003, 8), (2, 70_001, 64), (2, 50_000, 1), (2, 30_001, 5), (2, 20_001, 33),
         (1, 4096, 48), (1, 4096, 96))


def lookback_plan(j, window):
    """(checkpoint, aggregates) of tile ``j`` of a chain: the checkpoint
    whose state it starts from (None: from 0) and the tiles whose aggregates
    it composes onto it, in order (csrc/scan_common.cuh:look_back)."""
    c = j // window * window - 1
    return (c if c >= 0 else None), list(range(c + 1, j))


def is_checkpoint(j, window):
    """Whether tile ``j`` publishes its inclusive prefix (else its aggregate)."""
    return (j + 1) % window == 0


def _check_layout(r, l, d, reverse):
    tile = lr_tile_layout(r, l, d, reverse)
    # A group of contiguous channels dividing D, at most 64; 32 where D is a
    # multiple of 32, and D itself at the flagship's D = 8.
    assert d % tile.channels == 0 and 1 <= tile.channels <= 64
    if d % 32 == 0:
        assert tile.channels == 32
    elif d <= 64:
        assert tile.channels == d
    # One thread per (segment, channel), whole warps, within 256 threads.
    assert tile.segments >= 1
    assert tile.channels * tile.segments <= tile.threads <= 256 and tile.threads % 32 == 0
    assert tile.threads - tile.channels * tile.segments < 32
    assert 256 - tile.channels * tile.segments < tile.channels  # no room for one more segment
    assert tile.window >= 1
    assert tile.smem_bytes == (lr_tile_smem(tile.channels, tile.segments, reverse, tile.window))
    assert tile.smem_bytes >= (lookback_smem(tile.channels, tile.window)
                               + 2 * (3 if reverse else 2) * tile.segments * STEPS
                               * tile.channels * 4)
    # Two CTAs fit on an SM (the kernel's __launch_bounds__ asks for two).
    assert tile.smem_bytes <= BLOCK_SMEM_MAX
    assert 2 * (tile.smem_bytes + STATIC_SMEM + CTA_RESERVED_BYTES) <= SM_SMEM_BYTES
    # The tiles, the grid and the workspace's slots fit int32.
    n_tiles = -(-l // (tile.segments * STEPS))
    slots = r * (d // tile.channels) * n_tiles
    assert slots <= INT32_MAX
    assert lr_workspace_bytes(r, l, d, tile) == 24 * slots * tile.channels + 256
    return tile


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("r", [1, 4, 8])
@pytest.mark.parametrize("l,d", FLAGSHIP)
def test_lr_tile_layout_flagship(l, d, r, reverse):
    tile = _check_layout(r, l, d, reverse)
    # The flagship's groups, 8 and 32 channels, take the kernel's instances
    # compiled for them; the rows move as 16-byte pieces.
    assert tile.channels in (8, 32) and tile.channels % 4 == 0
    # The look-back's W: a tile reads at most ~8 KB of aggregates.
    assert (tile.window - 1) * 2 * tile.channels * 4 <= 8192


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("r,l,d", OTHER)
def test_lr_tile_layout_other_shapes(r, l, d, reverse):
    _check_layout(r, l, d, reverse)


@pytest.mark.parametrize("shape", [(0, 10, 8), (1, 0, 8), (1, 10, 0), (1 << 20, 1 << 20, 64)])
def test_lr_tile_layout_refuses(shape):
    with pytest.raises(ValueError):
        lr_tile_layout(*shape)


def _entry_tiles(j, window):
    """The tiles whose steps the state entering tile j holds, in the order
    the rule composes them: the checkpoint's own entry, the checkpoint, then
    the aggregates."""
    checkpoint, aggregates = lookback_plan(j, window)
    covered = [] if checkpoint is None else _entry_tiles(checkpoint, window) + [checkpoint]
    return covered + aggregates


@pytest.mark.parametrize("n,window", [(37, 8), (100, 16), (5, 8), (64, 64), (3, 1), (130, 64)])
def test_lookback_covers_each_earlier_tile_once(n, window):
    """n not a multiple of W, n < W, and W = 1 (every tile a checkpoint)."""
    for j in range(n):
        checkpoint, aggregates = lookback_plan(j, window)
        assert _entry_tiles(j, window) == list(range(j))
        # A tile reads only checkpoints' prefixes and other tiles' aggregates,
        # which they publish (checkpoints no aggregate, others no prefix).
        assert checkpoint is None or is_checkpoint(checkpoint, window)
        assert not any(is_checkpoint(m, window) for m in aggregates)
        assert len(aggregates) <= window - 1
        # The chain of checkpoints a tile waits on is j // W long.
        hops, c = 0, checkpoint
        while c is not None:
            hops, c = hops + 1, lookback_plan(c, window)[0]
        assert hops == j // window
    # In reverse the chain's tile j is the L-tile n - 1 - j: its entry state
    # covers the L-tiles after it.
    for jt in range(n):
        assert sorted(n - 1 - m for m in _entry_tiles(n - 1 - jt, window)) == list(range(jt + 1, n))


def _affine(a, b):
    """(P, S) of steps h -> a_t h + b_t folded in order along axis 1, fp32."""
    p, s = torch.ones_like(a[:, 0]), torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        s = torch.addcmul(b[:, t], a[:, t], s)
        p = p * a[:, t]
    return p, s


def _walk(a, b, segments, window):
    """The kernel's forward in fp32: tiles of ``segments`` × 16 steps, each
    segment folded, segments composed in order, the look-back's rule across
    tiles, then each segment re-walked from its entry state."""
    r, l, d = a.shape
    tile_len = segments * STEPS
    n = -(-l // tile_len)
    pad = n * tile_len - l
    a = torch.cat([a, torch.ones(r, pad, d)], 1).reshape(r, n, segments, STEPS, d)
    b = torch.cat([b, torch.zeros(r, pad, d)], 1).reshape(r, n, segments, STEPS, d)
    seg_p, seg_s = zip(*[_affine(a[:, j, i], b[:, j, i]) for j in range(n)
                         for i in range(segments)])
    seg_p = torch.stack(seg_p).reshape(n, segments, r, d)
    seg_s = torch.stack(seg_s).reshape(n, segments, r, d)
    agg = []
    for j in range(n):
        p, s = torch.ones(r, d), torch.zeros(r, d)
        for i in range(segments):  # compose(agg, part): second.p * first.p, fma
            p, s = seg_p[j, i] * p, torch.addcmul(seg_s[j, i], seg_p[j, i], s)
        agg.append((p, s))
    inclusive, out = {}, torch.empty(r, n, segments, STEPS, d)
    for j in range(n):
        checkpoint, aggregates = lookback_plan(j, window)
        p, s = torch.ones(r, d), torch.zeros(r, d)
        for m in aggregates:
            p, s = agg[m][0] * p, torch.addcmul(agg[m][1], agg[m][0], s)
        h = s if checkpoint is None else torch.addcmul(s, p, inclusive[checkpoint])
        if is_checkpoint(j, window):
            inclusive[j] = torch.addcmul(agg[j][1], agg[j][0], h)
        for i in range(segments):  # each segment's entry, then its re-walk
            entry, h = h, torch.addcmul(seg_s[j, i], seg_p[j, i], h)
            for t in range(STEPS):
                entry = torch.addcmul(b[:, j, i, t], a[:, j, i, t], entry)
                out[:, j, i, t] = entry
    return out.reshape(r, n * tile_len, d)[:, :l]


def _decays(rng, shape):
    dt = rng.uniform(0.001, 0.1, shape).astype(np.float32)
    return np.exp(-dt).astype(np.float32), (dt * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape,segments,window", [((2, 700, 8), 4, 3), ((1, 999, 5), 2, 8),
                                                   ((1, 300, 3), 1, 1)])
def test_lookback_walk_matches_jax(shape, segments, window):
    """The rule's fp32 walk (chains of 11 to 32 tiles, W from 1 to 8) against
    the JAX package's recurrence kernel in interpret mode; the reverse walk,
    on flipped inputs with the JAX `a_next` convention, against the port's
    plain reverse, itself held to JAX in tests/test_torch_scan_grad.py."""
    rng = np.random.default_rng(11)
    a, b = _decays(rng, shape)
    got = _walk(torch.from_numpy(a), torch.from_numpy(b), segments, window)
    ref = np.asarray(jax_lr(jnp.asarray(a), jnp.asarray(b), "interpret"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=FP32_TOL, atol=FP32_TOL)

    h, g = torch.from_numpy(ref.copy()), torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32))
    at = torch.from_numpy(a)
    a_next = torch.cat([at[:, 1:], torch.ones_like(at[:, :1])], 1)
    dh = _walk(a_next.flip(1), g.flip(1), segments, window).flip(1)
    da_ref, dh_ref = linear_recurrence_reverse_plain(at, h, g)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    torch.testing.assert_close(dh, dh_ref, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(dh * h_prev, da_ref, rtol=1e-3, atol=1e-3)


# The device epoch (csrc/scan_common.cuh: open_call, take_tile, close_call).
EPOCHS = 1 << 30  # epochs are 1 .. EPOCHS - 1


class Workspace:
    """The look-back's words: the epoch word (the last call's epoch), the
    tile ticket (epoch, next id), the done count, and per slot its aggregate
    and inclusive prefix, each (epoch, value, the call that wrote it)."""

    def __init__(self):
        self.zero()

    def zero(self):
        self.epoch, self.ticket, self.done = 0, (0, 0), 0
        self.agg, self.inc = {}, {}

    def is_zero(self):
        return (self.epoch, self.ticket, self.done) == (0, (0, 0), 0) and \
            not self.agg and not self.inc


def _cta(ws, call, values, window, grid, epoch_from_host, out, reads):
    """One CTA of a one-launch scan as a generator that yields at each memory
    step: its epoch, then tile ids from the ticket, the next taken while it
    walks the current one; tile id = j * chains + chain (the L-tile
    slowest). A tile's value composes by addition."""
    chains, n = len(values), len(values[0])
    total = chains * n
    epoch = ws.epoch + 1 if epoch_from_host is None else epoch_from_host

    def take():
        tag, nxt = ws.ticket
        tid, ws.ticket = (nxt, (tag, nxt + 1)) if tag == epoch else (0, (epoch, 1))
        if tid == total + grid - 1 and epoch_from_host is None:
            ws.epoch = epoch
        return tid

    yield
    tid = take()
    while tid < total:
        yield
        nxt = take()
        j, chain = divmod(tid, chains)
        checkpoint, aggregates = lookback_plan(j, window)
        if not is_checkpoint(j, window):
            ws.agg[chain, j] = (epoch, values[chain][j], call)
            yield
        needed = [(ws.agg, (chain, m)) for m in aggregates]
        if checkpoint is not None:
            needed.append((ws.inc, (chain, checkpoint)))
        while not all(d.get(k, (0,))[0] == epoch for d, k in needed):
            yield
        reads.update(d[k][2] for d, k in needed)
        entry = sum(d[k][1] for d, k in needed)
        if is_checkpoint(j, window):
            ws.inc[chain, j] = (epoch, entry + values[chain][j], call)
        out[chain][j] = entry
        tid = nxt
    yield
    if epoch == EPOCHS - 1:  # the last CTA of a call at the last epoch zeroes the words
        ws.done += 1
        if ws.done == grid:
            ws.zero()


def _call(ws, call, values, window, grid, rng, epoch_from_host=None):
    """One call on ``grid`` CTAs, their steps interleaved at random. Returns
    the state entering each tile (None: never walked) and the calls whose
    words the call read."""
    out = [[None] * len(values[0]) for _ in values]
    reads = set()
    ctas = [_cta(ws, call, values, window, grid, epoch_from_host, out, reads)
            for _ in range(grid)]
    for _ in range(100_000):
        if not ctas:
            return out, reads
        i = int(rng.integers(len(ctas)))
        try:
            next(ctas[i])
        except StopIteration:
            ctas.pop(i)
    raise AssertionError("the call did not end")


def _prefix_sums(values):
    return [list(np.cumsum([0] + list(v))[:-1]) for v in values]


@pytest.mark.parametrize("window,grid", [(4, 3), (8, 5), (1, 2)])
def test_device_epoch_replays_read_only_their_own_words(window, grid):
    """Two captured calls of other shapes on one workspace (their slots
    overlap), replayed in turns with fresh inputs copied in before each
    replay, across the wrap of the epoch: every replay reads only words its
    own replay wrote and gives the exact entry states; the call at the last
    epoch leaves the workspace zeroed. Baking the epoch into the graph, as a
    host-chosen epoch would be, fails on the second replay."""
    rng = np.random.default_rng(window * 10 + grid)
    shapes = [(2, 13), (3, 7)]  # (chains, tiles a chain) of the two captured calls
    ws = Workspace()
    ws.epoch = EPOCHS - 4  # the replays cross the last epoch
    for call in range(8):
        chains, n = shapes[call % 2]
        values = rng.integers(1, 1000, (chains, n)).tolist()
        out, reads = _call(ws, call, values, window, grid, rng)
        assert out == _prefix_sums(values)
        assert reads <= {call}
        if call == 2:  # the call at epoch EPOCHS - 1
            assert ws.is_zero()
        else:
            assert ws.epoch == (call + EPOCHS - 3 if call < 2 else call - 2)

    baked = Workspace()
    chains, n = shapes[0]
    results = [_call(baked, call, rng.integers(1, 1000, (chains, n)).tolist(), window, grid,
                     rng, epoch_from_host=1) for call in range(2)]
    assert results[0][1] <= {0}
    assert any(None in row for row in results[1][0])
