"""The port's scan ops (vm_asr_tpu_torch.ops) against the JAX package's, on
the CPU: the same numpy inputs through both. On the CPU the port's kernel
wrappers run their plain versions; the JAX kernels run in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vm_asr_tpu.ops import cross_merge as jax_cross_merge
from vm_asr_tpu.ops import cross_scan as jax_cross_scan
from vm_asr_tpu.ops import scan_api as jax_scan_api
from vm_asr_tpu.ops.linear_recurrence import linear_recurrence as jax_lr
from vm_asr_tpu.ops.selective_scan_fused import selective_scan_fused as jax_fused
from vm_asr_tpu.ops.selective_scan_ref import linear_recurrence_ref as jax_lr_ref
from vm_asr_tpu.ops.selective_scan_ref import selective_scan_ref as jax_ss_ref
from vm_asr_tpu_torch.ops import (
    cross_merge,
    cross_scan,
    linear_recurrence,
    scan_api,
    selective_scan,
    selective_scan_fused,
    selective_scan_ref,
)

# fp32 scans summed in another order (doubling scan vs chunked Pallas scan):
# the bar of tests/test_fused_scan.py:29-30.
FP32_TOL = 1e-4
# bf16 outputs: the fp32 results of the two scans differ by ~1e-6 relative,
# which can move a rounding to the neighbouring bf16 value, one ulp = 2^-7
# relative at most. Two ulps of the output scale allow for both sides.
BF16_TOL = 2.0 ** -6


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _decays(rng, shape):
    """a = exp(-dt) with dt in the model's range (dt_bias init 0.001..0.1,
    A = -1), b ~ dt·N(0, 1): the recurrence's real operating range."""
    dt = rng.uniform(0.001, 0.1, shape).astype(np.float32)
    return np.exp(-dt).astype(np.float32), (dt * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 300, 8), (1, 777, 64), (3, 1000, 5)])
def test_linear_recurrence_matches_jax(shape):
    rng = np.random.default_rng(0)
    a, b = _decays(rng, shape)
    got = linear_recurrence(_t(a), _t(b)).numpy()
    kernel = np.asarray(jax_lr(jnp.asarray(a), jnp.asarray(b), "interpret"))
    ref = np.asarray(jax_lr_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, kernel, rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(got, ref, rtol=FP32_TOL, atol=FP32_TOL)


def test_linear_recurrence_long_sequence():
    """L = 262 144 at D = 8, the output head's shape: the doubling scan's
    decay products underflow to 0 without harm (a cumprod closed form would
    divide by them)."""
    rng = np.random.default_rng(1)
    a, b = _decays(rng, (1, 262144, 8))
    got = linear_recurrence(_t(a), _t(b)).numpy()
    ref = np.asarray(jax_lr_ref(jnp.asarray(a), jnp.asarray(b)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=FP32_TOL, atol=FP32_TOL)


def _fused_inputs(rng, b, l, k, d, dtype):
    kd = k * d
    u = rng.standard_normal((b, l, kd)).astype(np.float32)
    dts = (rng.standard_normal((b, l, kd)) * 0.5).astype(np.float32)
    bs = rng.standard_normal((b, l, k)).astype(np.float32)
    cs = rng.standard_normal((b, l, k)).astype(np.float32)
    a = (-np.exp(rng.uniform(-1, 1, kd))).astype(np.float32)
    bias = rng.uniform(-5, -2, kd).astype(np.float32)  # softplus⁻¹ of 0.007..0.13
    dsk = rng.standard_normal(kd).astype(np.float32)
    jax_args = [jnp.asarray(x) for x in (u, dts, bs, cs)]
    torch_args = [_t(x) for x in (u, dts, bs, cs)]
    if dtype == "bfloat16":
        jax_args = [x.astype(jnp.bfloat16) for x in jax_args]
        torch_args = [x.to(torch.bfloat16) for x in torch_args]
    params = (a, bias, dsk)
    return (jax_args + [jnp.asarray(p) for p in params],
            torch_args + [_t(p) for p in params])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,k,d", [(2, 700, 4, 32), (1, 300, 4, 64)])
def test_fused_matches_jax_kernel(dtype, b, l, k, d):
    jax_args, torch_args = _fused_inputs(np.random.default_rng(2), b, l, k, d, dtype)
    ref = np.asarray(jax_fused(*jax_args, k, True), np.float32)
    got_t = selective_scan_fused(*torch_args, k)
    assert got_t.dtype == torch_args[0].dtype
    got = got_t.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        assert np.abs(got - ref).max() <= BF16_TOL * np.abs(ref).max()


def _scan_inputs(rng, b, l, k, d, n):
    u = rng.standard_normal((b, l, k, d)).astype(np.float32)
    dts = rng.uniform(-1, 1, (b, l, k, d)).astype(np.float32)
    A = -np.exp(rng.uniform(-1, 1, (k, d, n))).astype(np.float32)
    Bs = rng.standard_normal((b, l, k, n)).astype(np.float32)
    Cs = rng.standard_normal((b, l, k, n)).astype(np.float32)
    Dsk = rng.standard_normal((k, d)).astype(np.float32)
    bias = rng.uniform(0, 1, (k, d)).astype(np.float32)
    return (u, dts, A, Bs, Cs, Dsk, bias)


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize(
    "k,d,n,branch",
    [
        (4, 32, 1, "fused"),   # K·D = 128: the encoder/decoder stages
        (4, 16, 1, "lr"),      # K·D = 64: out_vss2
        (4, 2, 1, "lr"),       # K·D = 8: out_vss3
        (4, 8, 2, "lr"),       # N = 2: the general-N loop
    ],
)
def test_selective_scan_routing(k, d, n, branch, monkeypatch):
    args = _scan_inputs(np.random.default_rng(3), 2, 333, k, d, n)
    spies = {"fused": _Spy(scan_api.selective_scan_fused),
             "lr": _Spy(scan_api.linear_recurrence)}
    monkeypatch.setattr(scan_api, "selective_scan_fused", spies["fused"])
    monkeypatch.setattr(scan_api, "linear_recurrence", spies["lr"])
    got = selective_scan(*map(_t, args), delta_softplus=True).numpy()
    assert spies[branch].calls == (n if branch == "lr" else 1)
    assert sum(s.calls for s in spies.values()) == spies[branch].calls
    jargs = [jnp.asarray(x) for x in args]
    if branch == "fused":
        # impl="interpret" takes the Pallas fused kernel here
        ref = jax_scan_api.selective_scan(*jargs, True, impl="interpret")
    else:
        # impl="interpret" would force the fused kernel at any K·D
        # (scan_api.py:135-139): hold the LR branch against the LR kernel
        ref = jax_scan_api._selective_scan_local(
            *jargs, delta_softplus=True, impl="interpret", fused_lane_ok=False)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=FP32_TOL, atol=FP32_TOL)
    plain = selective_scan(*map(_t, args), delta_softplus=True, impl="plain").numpy()
    np.testing.assert_array_equal(plain, got)


def test_selective_scan_fp32_io():
    """SCAN_FP32_IO: bf16 activations are upcast before the scan, which then
    returns fp32 — the scan of the upcast inputs, exactly."""
    args = [_t(x) for x in _scan_inputs(np.random.default_rng(4), 1, 200, 4, 32, 1)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    y = selective_scan(*args, fp32_io=True)
    assert y.dtype == torch.float32
    up = [a.float() for a in args]
    torch.testing.assert_close(y, selective_scan(*up), rtol=0, atol=0)
    assert selective_scan(*args).dtype == torch.bfloat16


def test_selective_scan_ref_matches_jax():
    rng = np.random.default_rng(5)
    b, g, d, n, l = 2, 4, 6, 2, 150
    u = rng.standard_normal((b, g * d, l)).astype(np.float32)
    delta = rng.uniform(-1, 1, (b, g * d, l)).astype(np.float32)
    A = -np.exp(rng.uniform(-1, 1, (g * d, n))).astype(np.float32)
    Bm = rng.standard_normal((b, g, n, l)).astype(np.float32)
    Cm = rng.standard_normal((b, g, n, l)).astype(np.float32)
    D = rng.standard_normal(g * d).astype(np.float32)
    bias = rng.uniform(0, 1, g * d).astype(np.float32)
    args = (u, delta, A, Bm, Cm, D, bias)
    y, last = selective_scan_ref(*map(_t, args), delta_softplus=True, return_last_state=True)
    yj, lastj = jax_ss_ref(*map(jnp.asarray, args), delta_softplus=True,
                           return_last_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(lastj), rtol=FP32_TOL, atol=FP32_TOL)


def test_cross_scan_merge_non_square():
    """H ≠ W: the column directions go through reshape(b, w, h, c), which a
    square image cannot check."""
    rng = np.random.default_rng(6)
    h, w = 3, 5
    x = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    ys = rng.standard_normal((2, h * w, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(cross_scan(_t(x)).numpy(),
                                  np.asarray(jax_cross_scan(jnp.asarray(x))))
    np.testing.assert_allclose(cross_merge(_t(ys), h, w).numpy(),
                               np.asarray(jax_cross_merge(jnp.asarray(ys), h, w)),
                               rtol=1e-6, atol=1e-6)
    # adjoint: <cross_scan(x), ys> == <x, cross_merge(ys)>, in float64
    xd, yd = torch.from_numpy(x).double(), torch.from_numpy(ys).double()
    lhs = (cross_scan(xd) * yd).sum()
    rhs = (xd.reshape(2, h * w, 4) * cross_merge(yd, h, w)).sum()
    assert abs(lhs.item() - rhs.item()) < 1e-10


def test_kernel_wrappers_reject_unsupported_devices():
    """Off the CPU the wrappers launch their kernel or raise: a tensor on the
    meta device is neither, and must not fall through to the plain path."""
    a = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError):
        linear_recurrence(a, a)
    u = torch.empty((1, 8, 8), device="meta")
    bs = torch.empty((1, 8, 4), device="meta")
    p = torch.empty((8,), device="meta")
    with pytest.raises(ValueError):
        selective_scan_fused(u, u, bs, bs, p, p, p, 4)
