"""Kernel-equivalence checks and micro-benchmarks (port of vm_asr_tpu/checks.py;
the reference's CHECKS suite, vmamba.py:2303-2832).

    python -m vm_asr_tpu_torch.checks [--skip-bench] [--grid] [--device cpu]

On the card (the default) each check holds a CUDA kernel against its plain
PyTorch version on the same inputs, and fails unless the kernel's wrapper
counted the launches the check expects:

- the recurrence forward, and its gradients through the reverse kernel, at
  (4, 777, 96);
- the fused scan's backward at (2, 1500, 4·32), on the forward kernel's
  chunk states;
- the cross-scan's adjointness and gradient;
- with ``--grid``: fp32 and bf16 × L ∈ {64, 500, 777, 2048, 4096, 16384},
  the fused forward at two look-back windows × two grid sizes (the port's
  counterparts of the TPU kernel's two chunk lengths) and the fused
  backward, at the JAX package's bars (forward 1e-3 fp32, 3e-2 bf16;
  backward 1e-3, 4e-2 of each gradient's scale);
- unless ``--skip-bench``: the recurrence at (16, 16384, 128) in GB/s and
  ``VSSBlock(96)`` at (4, 56, 56, 96) (N = 1: the fused kernel), timed by
  CUDA events (core/profiling.benchmark).

With ``--device cpu`` no kernel runs: every check holds the plain fp32
route against the plain route in fp64 (``impl="plain64"``'s witness), says
so, and asserts that no kernel was launched.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict

import numpy as np
import torch

from .core.device import resolve_device
from .core.profiling import benchmark
from .ops import (
    cross_merge,
    cross_scan,
    linear_recurrence,
    linear_recurrence_plain,
    linear_recurrence_reverse,
    selective_scan,
    selective_scan_fused,
    selective_scan_fused_bwd,
    selective_scan_fused_bwd_plain,
    selective_scan_fused_fwd,
    selective_scan_fused_plain,
)

K = 4
# The grid's two settings of each kernel knob: the look-back's checkpoint
# spacing W, and a cap on the persistent grid (0: the whole card).
WINDOWS = (8, 32)
MAX_CTAS = (0, 5)
GRID_LENGTHS = (64, 500, 777, 2048, 4096, 16384)
_COUNTED = (selective_scan_fused, selective_scan_fused_bwd, linear_recurrence,
            linear_recurrence_reverse)


def _counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in _COUNTED}


class _Launches:
    """Asserts that a block launched exactly ``want`` kernels on the card,
    and none on the CPU."""

    def __init__(self, dev: torch.device, **want: int):
        self.want = want if dev.type == "cuda" else {}

    def __enter__(self):
        self.before = _counts()

    def __exit__(self, kind, *_):
        if kind is not None:
            return
        after = _counts()
        got = {k: after[k] - self.before[k] for k in after if after[k] != self.before[k]}
        if got != self.want:
            raise AssertionError(f"kernel launches {got}, expected {self.want}")


def _route(dev: torch.device) -> str:
    return "kernel vs plain" if dev.type == "cuda" else \
        "plain fp32 vs plain fp64 (CPU: no kernel ran)"


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    scale = max(ref.abs().max().item(), 1e-9)
    return (got.double() - ref.double()).abs().max().item() / scale


def check_scan_equivalence(dev: torch.device) -> Dict[str, float]:
    """The recurrence forward and its gradients (the reverse kernel) against
    the plain recurrence (counterpart of check_vssm1_ssoflex_equals_mambassm,
    vmamba.py:2496)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.2, 1.0, (4, 777, 96)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((4, 777, 96)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((4, 777, 96)).astype(np.float32)).to(dev)
    ref_dtype = torch.float32 if dev.type == "cuda" else torch.float64

    def grads(fn, dtype):
        a_, b_ = (t.to(dtype).requires_grad_(True) for t in (a, b))
        h = fn(a_, b_)
        return (h.detach(), *torch.autograd.grad((h * w.to(dtype)).sum(), (a_, b_)))

    with _Launches(dev, linear_recurrence=1, linear_recurrence_reverse=1):
        got = grads(linear_recurrence, torch.float32)
    ref = grads(linear_recurrence_plain, ref_dtype)
    fwd, da, db = ((g.double() - r.double()).abs().max().item() for g, r in zip(got, ref))
    print(f"[scan {_route(dev)}] (4, 777, 96) fwd max|Δ|={fwd:.2e} da={da:.2e} db={db:.2e}")
    assert fwd < 1e-4 and da < 1e-3 and db < 1e-3, (fwd, da, db)
    return dict(fwd=fwd, da=da, db=db)


def _fused_inputs(rng, b, l, kd, dev, dtype=torch.float32):
    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    u = t(rng.standard_normal((b, l, kd)))
    dts = t(rng.standard_normal((b, l, kd)) * 0.5)
    bs = t(rng.standard_normal((b, l, K)))
    cs = t(rng.standard_normal((b, l, K)))
    a = -t(rng.random(kd) * 2)
    bias = t(rng.standard_normal(kd) * 0.2)
    dsk = t(rng.standard_normal(kd))
    dy = t(rng.standard_normal((b, l, kd)))
    acts = [x.to(dtype) for x in (u, dts, bs, cs)]
    return acts, (a, bias, dsk), dy.to(dtype)


def _fused_bwd(acts, params, dy, dev):
    """The backward under test: the kernel on the forward kernel's chunk
    states (card), or the plain fp32 backward (CPU)."""
    if dev.type != "cuda":
        return selective_scan_fused_bwd_plain(*acts, dy, *params, K)
    _, h0, chunk = selective_scan_fused_fwd(*acts, *params, K)
    return selective_scan_fused_bwd(*acts, dy, *params, h0, chunk, K)


def _fused_bwd_ref(acts, params, dy, dev):
    """The plain backward in fp32 (card), or the fp64 witness (CPU): the
    gradient of <plain forward, dy> in fp64."""
    if dev.type == "cuda":
        return selective_scan_fused_bwd_plain(*acts, dy, *params, K)
    leaves = [x.double().requires_grad_(True) for x in (*acts, *params)]
    y = selective_scan_fused_plain(*leaves, K)
    return torch.autograd.grad((y * dy.double()).sum(), leaves)


def check_fused_backward(dev: torch.device) -> float:
    """The fused backward against the plain backward across chunk boundaries
    (counterpart of the CUDA bwd-vs-reference grid,
    test_selective_scan.py:545-563)."""
    acts, params, dy = _fused_inputs(np.random.default_rng(2), 2, 1500, K * 32, dev)
    with _Launches(dev, selective_scan_fused=1, selective_scan_fused_bwd=1):
        got = _fused_bwd(acts, params, dy, dev)
    worst = max(_rel(g, r) for g, r in zip(got, _fused_bwd_ref(acts, params, dy, dev)))
    print(f"[fused bwd {_route(dev)}] (2, 1500, 128) worst grad rel|Δ|={worst:.2e}")
    assert worst < 1e-3, worst
    return worst


def check_cross_scan(dev: torch.device) -> Dict[str, float]:
    """Adjointness and gradient of the cross-scan (counterpart of
    check_csm_triton, vmamba.py:2558-2724)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 6, 5, 7)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal((2, 30, 4, 7)).astype(np.float32)).to(dev)
    lhs = torch.vdot(cross_scan(x).flatten(), y.flatten()).item()
    rhs = torch.vdot(x.reshape(2, 30, 7).flatten(), cross_merge(y, 6, 5).flatten()).item()
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((cross_scan(xg) * y).sum(), xg)
    grad = (g - cross_merge(y, 6, 5).reshape(x.shape)).abs().max().item()
    print(f"[cross-scan] adjointness |Δ|={abs(lhs - rhs):.2e} grad max|Δ|={grad:.2e}")
    assert abs(lhs - rhs) < 1e-3 and grad < 1e-6, (lhs, rhs, grad)
    return dict(adjoint=abs(lhs - rhs), grad=grad)


def check_kernel_grid(dev: torch.device) -> Dict[str, float]:
    """fp32 and bf16 × L: the fused forward at every (window, grid cap)
    against the plain route of ``selective_scan`` on the same (quantised)
    inputs, and the fused backward against the plain backward (counterpart
    of the reference's parametrised sweep, test_selective_scan.py:545-563).
    On the CPU the candidates are the plain fp32 routes and the references
    their fp64 witnesses."""
    rng = np.random.default_rng(3)
    worst_fwd = worst_bwd = 0.0
    settings = [(w, c) for w in WINDOWS for c in MAX_CTAS] if dev.type == "cuda" else [None]
    for l in GRID_LENGTHS:
        for dtype in (torch.float32, torch.bfloat16):
            acts, params, dy = _fused_inputs(rng, 1, l, K * 32, dev, dtype)
            u4, dt4 = (x.reshape(1, l, K, 32) for x in acts[:2])
            a, bias, dsk = params
            ref_impl = "plain" if dev.type == "cuda" else "plain64"
            ref = selective_scan(u4, dt4, a.reshape(K, 32, 1), acts[2][..., None],
                                 acts[3][..., None], dsk.reshape(K, 32), bias.reshape(K, 32),
                                 impl=ref_impl).reshape(1, l, K * 32)
            tol = 1e-3 if dtype == torch.float32 else 3e-2
            fdiff = 0.0
            for setting in settings:
                if setting is None:
                    y = selective_scan_fused_plain(*acts, *params, K)
                else:
                    with _Launches(dev, selective_scan_fused=1):
                        y, _, _ = selective_scan_fused_fwd(*acts, *params, K, window=setting[0],
                                                           max_ctas=setting[1])
                fdiff = max(fdiff, _rel(y, ref))
            assert fdiff < tol, (l, dtype, fdiff)
            with _Launches(dev, selective_scan_fused=1, selective_scan_fused_bwd=1):
                got = _fused_bwd(acts, params, dy, dev)
            bdiff = max(_rel(g, r) for g, r in zip(got, _fused_bwd_ref(acts, params, dy, dev)))
            btol = 1e-3 if dtype == torch.float32 else 4e-2
            assert bdiff < btol, (l, dtype, bdiff)
            worst_fwd, worst_bwd = max(worst_fwd, fdiff), max(worst_bwd, bdiff)
            name = "f32" if dtype == torch.float32 else "bf16"
            print(f"[grid {_route(dev)}] L={l:<6} {name:<4} fwd rel|Δ|≤{fdiff:.2e} "
                  f"bwd rel|Δ|≤{bdiff:.2e}")
    print(f"[grid] worst fwd={worst_fwd:.2e} bwd={worst_bwd:.2e}")
    return dict(fwd=worst_fwd, bwd=worst_bwd)


def _timed(fn: Callable, *args, chain: Callable) -> float:
    return benchmark(fn, *args, iters=10, chain=chain)["seconds_per_call"]


def bench_scan(dev: torch.device) -> Dict[str, float]:
    """The recurrence at (16, 16384, 128): the kernel (card) or the plain
    version (CPU), in ms and effective GB/s (3 arrays of fp32 moved)."""
    a = torch.full((16, 16384, 128), 0.9, device=dev)
    b = torch.ones((16, 16384, 128), device=dev)
    feed = lambda out, a_, b_: (a_, b_ + 1e-6 * out)  # noqa: E731
    with torch.inference_mode():
        s = _timed(linear_recurrence, a, b, chain=feed)
        s_plain = _timed(linear_recurrence_plain, a, b, chain=feed)
    gbs = 3 * a.numel() * 4 / s / 1e9
    route = "kernel" if dev.type == "cuda" else "plain (CPU)"
    print(f"[scan] {route}: {s * 1e3:.3f} ms ({gbs:.0f} GB/s eff) | plain: "
          f"{s_plain * 1e3:.3f} ms  (16, 16384, 128) fp32")
    return dict(ms=s * 1e3, gb_per_s=gbs, plain_ms=s_plain * 1e3)


def bench_vssblock(dev: torch.device) -> Dict[str, float]:
    """VSSBlock(96) at (4, 56, 56, 96), fp32, N = 1 (counterpart of
    check_vssblock, vmamba.py:2745-2793)."""
    from .models import VSSBlock, init_parameters

    block = VSSBlock(96)
    init_parameters(block, torch.Generator().manual_seed(0))
    block = block.to(dev).eval()
    x = torch.zeros((4, 56, 56, 96), device=dev)
    with torch.inference_mode():
        s = _timed(block, x, chain=lambda out, v: (v + 1e-6 * out,))
    print(f"[vssblock] {s * 1e3:.3f} ms/call (B=4, 56×56×96, fp32, {dev.type})")
    return dict(ms=s * 1e3)


def run(argv=None) -> Dict[str, object]:
    """The checks of ``argv`` (see the module docstring); raises on a failed
    check. Returns their numbers."""
    p = argparse.ArgumentParser("python -m vm_asr_tpu_torch.checks")
    p.add_argument("--skip-bench", action="store_true")
    p.add_argument("--grid", action="store_true",
                   help="the dtype × length × (window, grid cap) kernel grid")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {args.device!r}")
    before = _counts()
    out = dict(device=dev.type, scan=check_scan_equivalence(dev),
               fused_bwd=check_fused_backward(dev), cross_scan=check_cross_scan(dev))
    if args.grid:
        out["grid"] = check_kernel_grid(dev)
    if not args.skip_bench:
        out["bench_scan"] = bench_scan(dev)
        out["bench_vssblock"] = bench_vssblock(dev)
    if dev.type == "cuda":
        print("all checks passed: every kernel against its plain version")
    else:
        if _counts() != before:
            raise AssertionError("a kernel was launched on the CPU")
        print("all checks passed on the CPU: plain fp32 routes against the fp64 witness; "
              "no kernel ran and no kernel was checked")
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
