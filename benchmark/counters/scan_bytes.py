"""The least HBM bytes of selective-scan calls: each input read once and
each output written once, in the precision the configuration states for
the scan's activations.

A call at (B, L, K·D, N) with K = 4 directions:

- forward: u and Δ read and y written (3 (B, L, K·D) passes), B and C read
  (2 (B, L, K, N) passes), A (K·D·N), D and the Δ bias (K·D each) read in
  fp32;
- backward: u, Δ, dy read and du, dΔ written (5 passes), B and C read and
  dB, dC written (4 (B, L, K, N) passes), the three parameters read and
  their gradients written in fp32.

This is the port's ``bench.scan_roofline_bytes`` (vm_asr_tpu_torch/bench.py)
without what that chained bench call adds to one call (the chain's read of
y or du, the ones it writes as dy) and without the chunk states H0, which
are the kernels' own choice and not a need of the scan.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

K = 4


def call_bytes(b: int, l: int, kd: int, n: int = 1, itemsize: int = 2) -> Dict[str, int]:
    kd_pass = b * l * kd * itemsize
    bc_pass = b * l * K * n * itemsize
    params = (kd * n + 2 * kd) * 4
    return {"fwd": 3 * kd_pass + 2 * bc_pass + params,
            "bwd": 5 * kd_pass + 4 * bc_pass + 2 * params}


def total_bytes(calls: Iterable[Tuple[int, int, int, int]], itemsize: int,
                backward: bool) -> int:
    """The least bytes of the recorded calls (B, L, K·D, N), forward only or
    forward and backward."""
    total = 0
    for b, l, kd, n in calls:
        c = call_bytes(b, l, kd, n, itemsize)
        total += c["fwd"] + (c["bwd"] if backward else 0)
    return total


def scan_itemsize(cfg: dict) -> int:
    """Bytes of a scan activation: the compute dtype, unless the
    configuration keeps the scan's inputs in fp32."""
    v = cfg["MODEL"]["VSSM"]
    low = cfg["AMP_ENABLE"] and cfg["DTYPE"]["COMPUTE"] in ("bfloat16", "float16")
    return 2 if low and not v.get("SCAN_FP32_IO", False) else 4
