"""The LayerNorm route of the port (models/layers.py:LayerNorm,
ops/layer_norm.py) on the CPU: the plain route is the expression it
replaced, bit for bit; the kernel's launch plan covers every row and
element once at the generators' and the classifier's shapes; CPU calls and
calls under autograd launch nothing; under autograd the gradient is torch's.
The kernel itself runs on the card only (chip_smoke.py holds it to the
plain version there)."""

import functools
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vm_asr_tpu_torch.models import layers
from vm_asr_tpu_torch.models.layers import LayerNorm
from vm_asr_tpu_torch.ops.layer_norm import (
    LAYER_NORM_KERNELS,
    kernel_route,
    layer_norm,
    layer_norm_plan,
)

# The module, which ops/__init__.py's function of the same name shadows.
ln_ops = importlib.import_module("vm_asr_tpu_torch.ops.layer_norm")

WIDTHS = (2, 4, 6, 8, 12, 16, 96, 384, 1536)
DTYPES = (torch.bfloat16, torch.float32)

# LayerNorm calls of one batch-1 forward, {(N, rows): calls}: the flagship
# generator at dims 16 and 24 (a 2.555 s segment, a 512 × 512 image; the v3
# head's last out_norm at N = 2), and VMamba-T v0 at 224² (one image).
CENSUS = {
    "vmasr48k_d16": {(2, 262144): 2, (4, 262144): 2, (8, 65536): 8, (16, 16384): 12,
                     (16, 65536): 2, (32, 4096): 18, (32, 16384): 6, (64, 1024): 18,
                     (64, 4096): 10, (128, 256): 16, (128, 1024): 10, (256, 256): 10},
    "vmasr48k_d24": {(2, 262144): 2, (6, 262144): 2, (12, 65536): 8, (24, 16384): 12,
                     (24, 65536): 2, (48, 4096): 18, (48, 16384): 6, (96, 1024): 18,
                     (96, 4096): 10, (192, 256): 16, (192, 1024): 10, (384, 256): 10},
    "vssm_tiny": {(96, 3136): 3, (192, 3136): 2, (384, 784): 3, (192, 784): 2,
                  (768, 196): 10, (384, 196): 9, (1536, 49): 3, (768, 49): 3},
}


def module(n, dtype, seed=0):
    m = LayerNorm(n, compute_dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        m.weight.copy_(torch.randn(n, generator=g))
        m.bias.copy_(torch.randn(n, generator=g))
    return m


def today(m, x):
    """models/layers.py's LayerNorm expression before the kernel."""
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps).to(m.compute_dtype)


def test_census_counts():
    assert {k: sum(v.values()) for k, v in CENSUS.items()} == dict(
        vmasr48k_d16=114, vmasr48k_d24=114, vssm_tiny=35)
    assert sum(n * r * c for (n, r), c in CENSUS["vmasr48k_d16"].items()) == 24_379_392
    assert sum(r * c for (n, r), c in CENSUS["vssm_tiny"].items()) == 23_618


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", WIDTHS)
def test_plain_route_is_todays_expression(n, dtype):
    m = module(n, dtype)
    x = (3.0 * torch.randn(5, 7, n, generator=torch.Generator().manual_seed(n)) + 1.5).to(dtype)
    with torch.no_grad():
        got = m(x)
    assert got.dtype == dtype and torch.equal(got, today(m, x))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_route_permuted_input(dtype):
    """The patch embedding's first norm sees a conv's NCHW output permuted
    to NHWC: channels strided."""
    m = module(96, dtype)
    x = torch.randn(2, 96, 6, 5, generator=torch.Generator().manual_seed(1)).to(dtype)
    x = x.permute(0, 2, 3, 1)
    assert not x.is_contiguous()
    with torch.no_grad():
        got = m(x)
    assert torch.equal(got, today(m, x))
    assert torch.equal(got, today(m, x.contiguous()))


@functools.lru_cache(maxsize=None)
def rows_once(rows, p, groups):
    """Whether the kernel's loop over row groups normalises every row once:
    group g of ``groups`` takes rows p·(g + i·groups) .. p·(g + i·groups)
    + p − 1, i = 0, 1, ..."""
    steps = -(-(-(-rows // p)) // groups)
    r0 = p * (np.arange(groups)[:, None] + groups * np.arange(steps)[None, :])
    r0 = r0[r0 < rows]
    idx = (r0[:, None] + np.arange(p)[None, :]).ravel()
    return bool((np.bincount(idx[idx < rows], minlength=rows) == 1).all())


def covered_columns(plan, n):
    """How often each column of a row is normalised: lane l of a group
    holds vectors (c·V + k)·G + l of the row, c < chunks, k < V, those
    inside it; a packed vector holds P whole rows."""
    if plan.rows_per_vec > 1:
        return np.ones(n, dtype=np.int64) * (plan.rows_per_vec * n == plan.vec)
    vecs, cols = n // plan.vec, np.zeros(n, dtype=np.int64)
    for lane in range(plan.lanes):
        for c in range(plan.chunks):
            for k in range(plan.vectors):
                j = (c * plan.vectors + k) * plan.lanes + lane
                if j < vecs:
                    cols[j * plan.vec:(j + 1) * plan.vec] += 1
    return cols


def check_plan(rows, n, itemsize, align=16):
    plan = layer_norm_plan(rows, n, itemsize, align)
    g = plan.lanes
    assert g & (g - 1) == 0 and 1 <= g <= 32 and plan.threads % 32 == 0, plan
    assert plan.vec * itemsize <= min(16, align) and plan.vectors <= 8, plan
    assert plan.rows_per_vec == 1 or (plan.vectors == 1 and g == 1 and plan.chunks == 1)
    assert n % plan.vec == 0 or plan.rows_per_vec > 1, plan
    assert (covered_columns(plan, n) == 1).all(), (n, plan)
    assert rows_once(rows, plan.rows_per_vec, plan.blocks * plan.threads // g), (rows, n, plan)
    return plan


@pytest.mark.parametrize("batch", (1, 4, 8))
@pytest.mark.parametrize("config", sorted(CENSUS))
def test_plan_covers_census_shapes(config, batch):
    for n, rows in CENSUS[config]:
        for itemsize in (2, 4):
            check_plan(rows * batch, n, itemsize)


def test_plan_named_shapes():
    """Widths the design names: N = 2 packs 4 rows a bf16 vector, N = 4 two;
    N = 96 takes 4 lanes × 3 vectors, N = 1536 32 × 6; N = 6 in 4-byte
    vectors."""
    plans = {n: layer_norm_plan(4096, n, 2) for n in (2, 4, 6, 96, 1536)}
    assert (plans[2].rows_per_vec, plans[4].rows_per_vec) == (4, 2)
    assert (plans[96].lanes, plans[96].vectors) == (4, 3)
    assert (plans[1536].lanes, plans[1536].vectors, plans[1536].chunks) == (32, 6, 1)
    assert plans[6].vec * 2 == 4


@pytest.mark.parametrize("itemsize", (2, 4))
def test_plan_any_width_takes_an_instance(itemsize):
    """Every width and alignment maps to a kernel instance that exists, and
    covers its row once, chunked rows and misaligned inputs included."""
    names = set(LAYER_NORM_KERNELS["norm"])
    tin = "__nv_bfloat16" if itemsize == 2 else "float"
    widths = list(range(1, 300)) + [383, 1000, 2047, 2049, 3072, 5000, 12289]
    for align in (itemsize, 4, 8, 16):
        if align < itemsize:
            continue
        for n in widths:
            plan = check_plan(3, n, itemsize, align)
            for tout in ("__nv_bfloat16", "float"):
                name = (f"void {ln_ops._NS}layer_norm_kernel<{tin}, {tout}, {plan.vec}, "
                        f"{plan.vectors}, {plan.rows_per_vec}>({ln_ops._NS}LnArgs)")
                assert name in names, (n, align, plan)


class FakeCuda(torch.Tensor):
    """A CPU tensor that says it is on the card, for the route's predicate."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_route_from_what_the_call_shows(dtype):
    m = module(16, dtype)
    x = torch.randn(4, 16).to(dtype).as_subclass(FakeCuda)
    args = (m.weight, m.bias, dtype)
    with torch.no_grad():
        assert kernel_route(x, *args)
    with torch.inference_mode():
        assert kernel_route(x, *args)
    assert not kernel_route(x, *args)  # the parameters need a gradient
    frozen = [t.detach() for t in (m.weight, m.bias)]
    assert kernel_route(x, *frozen, dtype)
    assert not kernel_route(x.detach().requires_grad_(), *frozen, dtype)
    assert not kernel_route(x.to(torch.float16), *args[:2], dtype)
    with torch.no_grad():
        assert not kernel_route(x, *args[:2], torch.float16)
        assert not kernel_route(torch.randn(4, 16).to(dtype), *args)  # on the CPU


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_module_sends_only_unrecorded_calls_to_the_kernel(dtype, monkeypatch):
    calls = []
    monkeypatch.setattr(layers, "layer_norm", lambda *a: calls.append(a) or a[0])
    m = module(8, dtype)
    x = torch.randn(3, 8).to(dtype).as_subclass(FakeCuda)
    y = m(x)  # autograd records it: torch's route
    assert not calls and torch.equal(y.as_subclass(torch.Tensor), today(m, x))
    with torch.no_grad():
        m(x)
    assert len(calls) == 1 and calls[0][4] == dtype


def test_cpu_and_autograd_calls_launch_nothing(monkeypatch):
    def refuse():
        raise AssertionError("the kernel was loaded")

    monkeypatch.setattr(ln_ops, "_kernel", refuse)
    before = layer_norm.launches
    m = module(12, torch.bfloat16)
    x = torch.randn(2, 5, 12)
    m(x).float().sum().backward()
    with torch.no_grad():
        m(x)
    with torch.inference_mode():
        m(x)
    assert torch.equal(layer_norm(x, m.weight.detach(), m.bias.detach(), m.eps, torch.bfloat16),
                       today(m, x))
    assert layer_norm.launches == before


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_gradient_is_torchs(dtype):
    m = module(96, dtype, seed=3)
    x = torch.randn(4, 3, 96, generator=torch.Generator().manual_seed(2)).to(dtype)
    cot = torch.randn(4, 3, 96, generator=torch.Generator().manual_seed(4)).to(dtype)
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    params = [m.weight, m.bias]
    got = torch.autograd.grad((m(x1) * cot).sum(), [x1] + params)
    want = torch.autograd.grad((today(m, x2) * cot).sum(), [x2] + params)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
