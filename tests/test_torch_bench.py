"""The scan's byte count (vm_asr_tpu_torch/bench.py:scan_roofline_bytes),
which benchmark/tests/test_counters.py holds benchmark/counters/scan_bytes.py
to: equal to the JAX bench's expression at the JAX kernel's chunk, but for
the passes the two kernels move differently; written out by hand at the
shape test_counters.py uses; and equal to the bytes of the tensors one call
reads and writes, as the kernels' plain versions make them."""

import pytest
import torch

from vm_asr_tpu.ops.selective_scan_fused import _default_chunk as jax_chunk
from vm_asr_tpu_torch import bench
from vm_asr_tpu_torch.ops.selective_scan_fused import (
    chunk_length,
    fused_chunk_states_plain,
    selective_scan_fused_bwd_plain,
    selective_scan_fused_plain,
)

K = 4

SHAPES = [(8, 16384, 128), (4, 4096, 256), (2, 1536, 132)]


@pytest.mark.parametrize("shape", SHAPES)
def test_scan_bytes_are_the_jax_bench_expression(shape):
    """bench.py:486-493 at the JAX kernel's chunk: the forward is the same
    count; forward + backward differs by the 6 (B, L, K) passes of the JAX
    backward's fp32 B/C casts and fp32 dB/dC (the port's kernels read and
    write them in the IO dtype)."""
    batch, l, kd = shape
    isz, k = 2, 4
    kd_pass = batch * l * kd * isz
    k_pass = batch * l * k * isz
    ckpt = batch * (l // jax_chunk(l)) * kd * 4
    fwd_bytes = 4 * kd_pass + 2 * k_pass + ckpt
    grad_bytes = 10 * kd_pass + 2 * ckpt + (4 + 2 * 2 + 2 * 2) * k_pass
    got = bench.scan_roofline_bytes(batch, l, kd, chunk=jax_chunk(l))
    assert got["fwd"] == fwd_bytes
    assert got["fwd_bwd"] == grad_bytes - 6 * k_pass


def test_scan_bytes_take_the_port_kernels_chunk():
    """At (8, 16384, 128) in bf16, the call test_counters.py compares: u,
    dts, y and the caller's read of y, B and C, and H0 in fp32 at the port
    kernels' chunk forward; 10 (B, L, K·D) and 6 (B, L, K) passes and H0
    twice forward + backward."""
    b, l, kd = 8, 16384, 128
    chunk = chunk_length(b, l, kd)
    got = bench.scan_roofline_bytes(b, l, kd)
    assert got == bench.scan_roofline_bytes(b, l, kd, chunk=chunk)
    h0 = b * (l // chunk) * kd * 4
    assert got["fwd"] == 4 * b * l * kd * 2 + 2 * b * l * 4 * 2 + h0
    assert got["fwd_bwd"] == 10 * b * l * kd * 2 + 6 * b * l * 4 * 2 + 2 * h0


# Ragged L (1000, 4100: the last chunk short), an odd D (K·D = 132), chunks of
# 16 and 32 steps, and bf16 and fp32 IO.
CALLS = [((2, 1000, 128), torch.bfloat16), ((1, 300, 132), torch.bfloat16),
         ((2, 1000, 128), torch.float32), ((2, 16384, 132), torch.bfloat16),
         ((1, 4100, 1024), torch.float32)]


@pytest.mark.parametrize("shape,dtype", CALLS)
def test_scan_bytes_are_the_tensors_of_one_call(shape, dtype):
    """The count against the tensors of one call made by the kernels' plain
    versions: u, dts, B, C and y in the IO dtype, H0 as the forward kernel
    writes it at the port's chunk (fp32, one state per chunk begun), and
    du, ddts, dB, dC in the dtypes the backward writes them. Forward: the
    inputs read, y written and read once by the caller, H0 written. Forward
    + backward: the forward but the caller's read; dy written as ones; the
    backward's reads of u, dts, B, C, dy and H0 and its writes of du, ddts,
    dB, dC; the caller's read of du."""
    b, l, kd = shape
    gen = torch.Generator().manual_seed(0)
    u, dts = (torch.randn(b, l, kd, generator=gen).to(dtype) for _ in range(2))
    bs, cs = (torch.randn(b, l, K, generator=gen).to(dtype) for _ in range(2))
    a_neg = -torch.rand(kd, generator=gen) - 0.5
    dt_bias, d_skip = torch.zeros(kd), torch.ones(kd)
    params = (a_neg, dt_bias, d_skip, K)
    y = selective_scan_fused_plain(u, dts, bs, cs, *params)
    h0 = fused_chunk_states_plain(u, dts, bs, cs, *params, chunk_length(b, l, kd))
    dy = torch.ones_like(y)
    du, ddts, dbs, dcs, *_ = selective_scan_fused_bwd_plain(u, dts, bs, cs, dy, *params)

    def nbytes(*tensors):
        return sum(t.nbytes for t in tensors)

    got = bench.scan_roofline_bytes(b, l, kd, itemsize=u.element_size())
    assert got["fwd"] == nbytes(u, dts, bs, cs, y, y, h0)
    assert got["fwd_bwd"] == nbytes(u, dts, bs, cs, y, h0, dy, u, dts, bs, cs, dy, h0,
                                     du, ddts, dbs, dcs, du)
