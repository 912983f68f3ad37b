"""Gradients of the port's scan ops against the JAX package's, on the CPU.

The port's ``selective_scan_fused`` and ``linear_recurrence`` are autograd
Functions; on CPU tensors their backward runs the plain versions (the ports
of ``_fused_bwd_xla`` and ``_lr_bwd``). The JAX side runs ``jax.grad``
through the Pallas kernels in interpret mode, so ``_fused_bwd_pallas`` and
the reversed ``_lr_pallas`` are the oracles. The same numpy inputs and the
same output weights go to both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu.ops import scan_api as jax_scan_api
from vm_asr_tpu.ops.linear_recurrence import linear_recurrence as jax_lr
from vm_asr_tpu.ops.selective_scan_fused import selective_scan_fused as jax_fused
from vm_asr_tpu_torch.ops import (
    linear_recurrence,
    linear_recurrence_plain,
    linear_recurrence_reverse,
    selective_scan,
    selective_scan_fused,
    selective_scan_fused_bwd,
    selective_scan_fused_plain,
)

# The JAX package's bar for all seven scan gradients
# (tests/test_fused_scan.py:50-51): fp32 gradients summed in another order.
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
# bf16 du, ddts, dB, dC: both sides compute in fp32 and round once to bf16,
# and values ~1e-6 apart can round to neighbouring bf16 values: one ulp is at
# most 2^-7 of the value.
BF16_GRAD_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
NAMES = ("u", "dts", "bs", "cs", "A", "dt_bias", "D")


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _fused_inputs(rng, b, l, k, d):
    kd = k * d
    return [
        rng.standard_normal((b, l, kd)).astype(np.float32),
        (rng.standard_normal((b, l, kd)) * 0.5).astype(np.float32),
        rng.standard_normal((b, l, k)).astype(np.float32),
        rng.standard_normal((b, l, k)).astype(np.float32),
        (-np.exp(rng.uniform(-1, 1, kd))).astype(np.float32),
        rng.uniform(-5, -2, kd).astype(np.float32),  # softplus⁻¹ of 0.007..0.13
        rng.standard_normal(kd).astype(np.float32),
    ]


def _torch_fused_grads(args, w, k, dtype, fn=selective_scan_fused):
    ts = [_t(a) for a in args]
    ts[:4] = [t.to(dtype) for t in ts[:4]]
    ts = [t.requires_grad_() for t in ts]
    y = fn(*ts, k)
    (y.float() * _t(w)).sum().backward()
    return y, [t.grad for t in ts]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,d", [(700, 32), (777, 64), (777, 48)])
def test_fused_grads_match_jax_kernel(dtype, l, d):
    """All seven gradients against jax.grad through the Pallas backward in
    interpret mode. L is no multiple of the JAX kernel's 512-chunk, so it
    runs two chunks with a ragged tail. D = 48 is the first stage of the
    dims-24 config, no multiple of a warp."""
    b, k = 2, 4
    rng = np.random.default_rng(10 + d)
    args = _fused_inputs(rng, b, l, k, d)
    w = rng.standard_normal((b, l, k * d)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jargs = [jnp.asarray(a) for a in args]
    jargs[:4] = [a.astype(jdt) for a in jargs[:4]]

    def loss(*xs):
        y = jax_fused(*xs, k, True)
        return jnp.sum(y.astype(jnp.float32) * w)

    ref = jax.grad(loss, argnums=tuple(range(7)))(*jargs)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    _, got = _torch_fused_grads(args, w, k, tdt)
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == (tdt if name in NAMES[:4] else torch.float32), name
        tol = BF16_GRAD_TOL if (dtype == "bfloat16" and name in NAMES[:4]) else GRAD_TOL
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32),
                                   err_msg=f"d{name}", **tol)


def test_fused_plain_bwd_matches_autograd():
    """The plain backward against torch autograd through the plain forward
    (a doubling scan, differentiated op by op). Both are fp32 and differ only
    in the order of their sums: the forward-kernel bar of 1e-4."""
    b, l, k, d = 2, 300, 4, 8
    rng = np.random.default_rng(20)
    args = [_t(a) for a in _fused_inputs(rng, b, l, k, d)]
    w = _t(rng.standard_normal((b, l, k * d)))
    leaves = [a.clone().requires_grad_() for a in args]
    y = selective_scan_fused_plain(*leaves, k)
    (y * w).sum().backward()
    got = selective_scan_fused_bwd(*args[:4], w, *args[4:], None, None, k)
    for name, g, leaf in zip(NAMES, got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("shape", [(2, 300, 8), (1, 777, 64)])
def test_linear_recurrence_grads_match_jax(shape):
    """(da, db) against jax.grad of the LR kernel in interpret mode, whose
    backward is the same kernel time-reversed."""
    rng = np.random.default_rng(30)
    dt = rng.uniform(0.001, 0.1, shape).astype(np.float32)
    a = np.exp(-dt).astype(np.float32)
    b = (dt * rng.standard_normal(shape)).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    ref = jax.grad(lambda x, y: jnp.sum(jax_lr(x, y, "interpret") * w), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    (linear_recurrence(ta, tb) * _t(w)).sum().backward()
    for g, r in zip((ta.grad, tb.grad), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD_TOL)
    # The reverse wrapper alone gives the same pair, from the forward's h.
    h = linear_recurrence_plain(_t(a), _t(b))
    da, db = linear_recurrence_reverse(_t(a), h, _t(w))
    torch.testing.assert_close(da, ta.grad, rtol=0, atol=0)
    torch.testing.assert_close(db, tb.grad, rtol=0, atol=0)


def _scan_inputs(rng, b, l, k, d):
    return [
        rng.standard_normal((b, l, k, d)).astype(np.float32),
        rng.uniform(-1, 1, (b, l, k, d)).astype(np.float32),
        -np.exp(rng.uniform(-1, 1, (k, d, 1))).astype(np.float32),
        rng.standard_normal((b, l, k, 1)).astype(np.float32),
        rng.standard_normal((b, l, k, 1)).astype(np.float32),
        rng.standard_normal((k, d)).astype(np.float32),
        rng.uniform(0, 1, (k, d)).astype(np.float32),
    ]


@pytest.mark.parametrize("k,d,route", [(4, 32, "fused"), (4, 16, "lr"), (4, 2, "lr")])
def test_selective_scan_grads_both_routes(k, d, route):
    """Gradients of all seven inputs through scan_api.selective_scan, on the
    fused route (K·D = 128) and the recurrence route (K·D = 64, 8), against
    the JAX package's same route; impl="plain" gives the same gradients by
    plain autograd."""
    rng = np.random.default_rng(40 + d)
    b, l = 2, 333
    args = _scan_inputs(rng, b, l, k, d)
    w = rng.standard_normal((b, l, k, d)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in args]
    if route == "fused":
        fwd = lambda *xs: jax_scan_api.selective_scan(*xs, True, impl="interpret")  # noqa: E731
    else:
        fwd = lambda *xs: jax_scan_api._selective_scan_local(  # noqa: E731
            *xs, delta_softplus=True, impl="interpret", fused_lane_ok=False)
    ref = jax.grad(lambda *xs: jnp.sum(fwd(*xs) * w), argnums=tuple(range(7)))(*jargs)

    grads = {}
    for impl in ("kernel", "plain"):
        leaves = [_t(a).requires_grad_() for a in args]
        y = selective_scan(*leaves, delta_softplus=True, impl=impl)
        (y * _t(w)).sum().backward()
        grads[impl] = [x.grad for x in leaves]
    for i, (g, r) in enumerate(zip(grads["kernel"], ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=f"input {i}", **GRAD_TOL)
        np.testing.assert_allclose(grads["plain"][i].numpy(), g.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,d", [(4, 32), (4, 2)])
def test_selective_scan_plain64_witness(k, d):
    """impl="plain64" computes the plain routes in fp64 and returns u's
    dtype: it agrees with the fp32 routes to their rounding, and so do the
    gradients it passes back."""
    rng = np.random.default_rng(60 + d)
    args = _scan_inputs(rng, 2, 333, k, d)
    w = _t(rng.standard_normal((2, 333, k, d)))
    out, grads = {}, {}
    for impl in ("plain", "plain64"):
        leaves = [_t(a).requires_grad_() for a in args]
        out[impl] = selective_scan(*leaves, delta_softplus=True, impl=impl)
        (out[impl] * w).sum().backward()
        grads[impl] = [x.grad for x in leaves]
    assert out["plain64"].dtype == torch.float32
    assert not torch.equal(out["plain64"], out["plain"])  # fp64 maths did run
    torch.testing.assert_close(out["plain64"], out["plain"], rtol=1e-5, atol=1e-5)
    for i, (g64, g32) in enumerate(zip(grads["plain64"], grads["plain"])):
        assert g64.dtype == torch.float32
        torch.testing.assert_close(g64, g32, rtol=1e-4, atol=1e-4, msg=f"input {i}")


def test_selective_scan_fp32_io_grads():
    """With fp32_io the bf16 activations are upcast before the scan; their
    gradients come back in bf16, those of the upcast scan rounded once."""
    rng = np.random.default_rng(50)
    args = [_t(a) for a in _scan_inputs(rng, 1, 200, 4, 32)]
    w = _t(rng.standard_normal((1, 200, 4, 32)))
    act = (0, 1, 3, 4)
    leaves = [a.to(torch.bfloat16) if i in act else a.clone() for i, a in enumerate(args)]
    leaves = [x.requires_grad_() for x in leaves]
    (selective_scan(*leaves, fp32_io=True) * w).sum().backward()
    up = [x.detach().float().requires_grad_() for x in leaves]
    (selective_scan(*up) * w).sum().backward()
    for i, (x, y) in enumerate(zip(leaves, up)):
        assert x.grad.dtype == x.dtype
        torch.testing.assert_close(x.grad, y.grad.to(x.dtype), rtol=0, atol=0,
                                   msg=f"input {i}")
