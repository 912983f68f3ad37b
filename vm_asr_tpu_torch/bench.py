"""The HBM bytes of one fused selective-scan call (``scan_roofline_bytes``),
the count that ``benchmark/tests/test_counters.py`` holds
``benchmark/counters/scan_bytes.py`` to. Nothing in the program calls it; the
port's benchmark is ``benchmark/run.py``, its cells in BENCHMARK.json.
"""

from __future__ import annotations

from typing import Dict, Optional

from .ops.selective_scan_fused import chunk_length

K = 4


def scan_roofline_bytes(batch: int, l: int, kd: int, k: int = K, itemsize: int = 2,
                        chunk: Optional[int] = None) -> Dict[str, int]:
    """HBM bytes of one call of the fused scan, forward and forward +
    backward: each input read once and each output written once, with what
    a caller that reduces the call's output adds (a read of y; dy written as
    ones and a read of du), which test_counters.py takes off again:

    - forward: u and dts read, y written, and y read by the caller (4
      (B, L, K·D) passes of ``itemsize`` bytes); B and C read (2 (B, L, K)
      passes); the chunk-entry states H0 written, fp32, one per (row,
      L-chunk begun, channel);
    - forward + backward: the forward's 3 passes and H0; dy = ones written
      (1); the backward kernel's u, dts and dy read and du, ddts written
      (5) and H0 read; du read by the caller (1): 10 passes and H0 twice;
      B and C read by both kernels and dB, dC written (6 (B, L, K) passes).

    ``chunk`` defaults to the port kernels' own L-chunk at this shape
    (``ops.selective_scan_fused.chunk_length``), so H0 is what the forward
    kernel writes. The JAX bench (bench.py:486-493) counts the same
    (B, L, K·D) passes, H0 at its own chunk (256 or 512), and 12 (B, L, K)
    passes in forward + backward where the port's kernels move 6: both read
    B and C in each kernel (4), but JAX adds fp32 casts of B and C (4) and
    writes dB and dC in fp32 (4), where the port writes them in the IO
    dtype (2). The (A, dt_bias, D) vectors (K·D fp32 each) are left out on
    both sides. Bytes ÷ the HBM rate is the "Bound ms" yardstick of PERF.md's
    kernel table; that table counts one kernel call, without the caller's
    reads or the ones."""
    chunk = chunk or chunk_length(batch, l, kd)
    kd_pass = batch * l * kd * itemsize
    k_pass = batch * l * k * itemsize
    h0 = batch * (-(-l // chunk)) * kd * 4
    return {"fwd": 4 * kd_pass + 2 * k_pass + h0,
            "fwd_bwd": 10 * kd_pass + 2 * h0 + 6 * k_pass}
