"""The port's FLOP counters, trace and NaN guard (vm_asr_tpu_torch/core/
profiling.py) on the CPU: the counterparts of tests/test_profiling.py by
hand count, and ``matmul_flops`` equal to the JAX package's jaxpr walk on
the same models, exactly.

Conventions the counts share with JAX: 2·M·N·K a product, 2·prod(out)·
C_in-per-group·K_spatial a convolution. A depthwise convolution counts
nothing (JAX writes it as shifted multiply-adds), and a transposed one counts
over stride × its input's size (JAX's lhs-dilated convolution at "SAME"
padding), not over its input as torch.utils.flop_counter does."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

import flax.linen as fnn
import jax
import jax.numpy as jnp

from vm_asr_tpu.compat.torch_port import state_dict_to_flax
from vm_asr_tpu.core.profiling import flops_selective_scan as jax_flops_selective_scan
from vm_asr_tpu.core.profiling import matmul_flops as jax_matmul_flops
from vm_asr_tpu.models import DualStreamInteractiveMambaUNet as JaxDual
from vm_asr_tpu.models import VSSM as JaxVSSM
from vm_asr_tpu_torch.core import load_config
from vm_asr_tpu_torch.core.profiling import (
    debug_nan_context,
    flops_selective_scan,
    matmul_flops,
    model_flops,
    profile_trace,
)
from vm_asr_tpu_torch.models import ConvTranspose2d, generator_kwargs, get_generator, get_vssm

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_dot_plain():
    assert matmul_flops(lambda a, b: a @ b, torch.zeros(4, 8), torch.zeros(8, 16)) \
        == 2 * 4 * 16 * 8


def test_dot_batched():
    f = lambda a, b: torch.einsum("bik,bkj->bij", a, b)  # noqa: E731
    assert matmul_flops(f, torch.zeros(3, 4, 8), torch.zeros(3, 8, 16)) == 3 * 2 * 4 * 16 * 8
    assert matmul_flops(torch.bmm, torch.zeros(3, 4, 8), torch.zeros(3, 8, 16)) \
        == 3 * 2 * 4 * 16 * 8


def test_linear_with_bias_and_leading_axes():
    lin = torch.nn.Linear(8, 16)
    assert matmul_flops(lin, torch.zeros(2, 5, 7, 8)) == 2 * (2 * 5 * 7) * 16 * 8


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "enable_grad"])
def test_counts_alike_in_every_grad_mode(mode):
    """Inference mode hands a dispatch mode aten.linear and aten.matmul
    undecomposed; the count is the same in it."""
    lin = torch.nn.Linear(8, 16, bias=False)
    with getattr(torch, mode)():
        x = torch.zeros(2, 5, 7, 8)
        got = matmul_flops(lambda v: torch.matmul(lin(v), torch.zeros(16, 3)), x)
    assert got == 2 * 70 * 16 * 8 + 2 * 70 * 3 * 16


def test_einsum_over_a_contraction_of_one():
    """torch runs it as a broadcast multiply; JAX's dot_general counts it."""
    f = lambda a, b: torch.einsum("blkr,kdr->blkd", a, b)  # noqa: E731
    assert matmul_flops(f, torch.zeros(2, 6, 4, 1), torch.zeros(4, 5, 1)) == 2 * 2 * 6 * 4 * 5


def test_einsum_of_three_operands_counts_each_pair():
    """A longer einsum is a chain of pairwise products in both packages, each
    counted: (2×3)(3×4) then (2×4)(4×5), the cheapest order."""
    f = lambda a, b, c: torch.einsum("ij,jk,kl->il", a, b, c)  # noqa: E731
    shapes = [(2, 3), (3, 4), (4, 5)]
    want = jax_matmul_flops(lambda a, b, c: jnp.einsum("ij,jk,kl->il", a, b, c),
                            *(jnp.zeros(s) for s in shapes))
    assert want == 2 * 2 * 4 * 3 + 2 * 2 * 5 * 4
    assert matmul_flops(f, *(torch.zeros(s) for s in shapes)) == want


def test_conv():
    f = lambda x, w: F.conv2d(x, w, padding=1)  # noqa: E731
    # 2 * prod(out=(1,5,8,8)) * Cin_per_group=3 * K_spatial=9
    assert matmul_flops(f, torch.zeros(1, 3, 8, 8), torch.zeros(5, 3, 3, 3)) \
        == 2 * (1 * 5 * 8 * 8) * 3 * 9


def test_grouped_conv_counts_cin_per_group():
    f = lambda x, w: F.conv1d(x, w, padding=1, groups=4)  # noqa: E731
    x, w = torch.zeros(1, 8, 16), torch.zeros(8, 2, 3)  # 8 → 8 channels, 2 a group
    assert matmul_flops(f, x, w) == 2 * (1 * 8 * 16) * 2 * 3


def test_depthwise_conv_counts_nothing():
    f = lambda x, w: F.conv1d(x, w, padding=1, groups=4)  # noqa: E731
    assert matmul_flops(f, torch.zeros(1, 4, 16), torch.zeros(4, 1, 3)) == 0


def test_transposed_conv_matches_jax():
    """The port's ConvTranspose2d (torch's transposed conv cropped to flax's
    "SAME" output) against flax ConvTranspose: JAX counts the lhs-dilated
    conv over its 2H × 2W output."""
    x = np.zeros((2, 5, 7, 6), np.float32)
    jm = fnn.ConvTranspose(4, (3, 3), strides=(2, 2), padding="SAME")
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    want = jax_matmul_flops(lambda p, v: jm.apply(p, v), params, jnp.asarray(x))
    assert want == 2 * (2 * 10 * 14 * 4) * 6 * 9
    assert matmul_flops(ConvTranspose2d(6, 4), torch.from_numpy(x)) == want


def test_loop_counts_every_product():
    """The counterpart of the JAX scan case: a Python loop of 10 products."""
    def loop(a):
        c = torch.eye(8)
        for _ in range(10):
            c = c @ a
        return c

    assert matmul_flops(loop, torch.eye(8)) == 10 * 2 * 8 * 8 * 8


def test_checkpoint_under_no_grad_counts_once():
    """The counterpart of the JAX remat case: a checkpointed product runs
    once under no_grad, and counts once."""
    a, b = torch.zeros(4, 8), torch.zeros(8, 16)
    with torch.no_grad():
        got = matmul_flops(lambda a, b: checkpoint(torch.mm, a, b, use_reentrant=False) + 1, a, b)
    assert got == 2 * 4 * 16 * 8


def _jax_generator(opts):
    """The flagship config (its widths; depths cut to 1-1-1-1 on both sides
    to keep the CPU forward short), the port's generator and its JAX twin
    (the "ref" scan: no pallas_call for the jaxpr walk to enter)."""
    cfg = load_config(str(ROOT / "configs/vm_asr_48k_MPD.yaml"),
                      ["AMP_ENABLE", "False", "MODEL.VSSM.DEPTHS", "[1, 1, 1, 1]"] + opts)
    kw = generator_kwargs(cfg)
    kw.pop("compute_dtype")
    kw.pop("scan_fp32_io")
    return cfg, get_generator(cfg, "cpu"), JaxDual(scan_impl="ref", dtype=jnp.float32, **kw)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("head", ["v3", "v1"])
def test_generator_matches_jax(head, batch):
    """The flagship generator's forward at batch 1 and 2 (head v3, and v1
    with its transposed convs): the port's count equals the JAX package's.
    Batch 2 stands for the batched forwards of segment buckets 2-8, which
    serve most of the serve cells' segments."""
    cfg, port, jm = _jax_generator(["MODEL.VSSM.OUTPUT", head])
    t = int(cfg.DATA.SEGMENT * cfg.DATA.TARGET_SR)
    x, hf = jnp.zeros((batch, 1, t)), jnp.full((batch,), 171)
    if head == "v1":  # the JAX package's converter rejects the v1 head
        params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, hf)["params"]
    else:  # the port's weights, which save tracing the JAX init
        params = state_dict_to_flax({k: v.numpy() for k, v in port.state_dict().items()},
                                    drop_phase_decoders=False)
    want = jax_matmul_flops(lambda p, x, hf: jm.apply({"params": p}, x, hf), params, x, hf)
    wave = np.random.default_rng(0).standard_normal((batch, 1, t)).astype(np.float32)
    with torch.no_grad():
        got = matmul_flops(port, torch.from_numpy(wave), torch.full((batch,), 171))
    assert got == want


def test_vssm_matches_jax_and_model_flops_adds_the_scans():
    kw = dict(num_classes=10, dims=8, depths=(1, 1, 1, 1), ssm_d_state=4)
    x = jnp.zeros((2, 32, 32, 3))
    jm = JaxVSSM(scan_impl="ref", **kw)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"]
    want = jax_matmul_flops(lambda p, v: jm.apply({"params": p}, v), params, x)
    port = get_vssm("cpu", **kw)
    image = torch.zeros(2, 32, 32, 3)
    with torch.no_grad():
        assert matmul_flops(port, image) == want
    # One SS2D a stage, at 8², 4², 2², 1² with K·d_inner = 4·2·8·2^i.
    scans = sum(jax_flops_selective_scan(2, (8 >> i) ** 2, 4 * 16 << i, 4) for i in range(4))
    assert scans == sum(flops_selective_scan(2, (8 >> i) ** 2, 4 * 16 << i, 4) for i in range(4))
    got = model_flops(port, image)
    assert math.isclose(got["gflops"] * 1e9, want + scans, rel_tol=1e-12)
    assert math.isclose(got["scan_gflops"] * 1e9, scans, rel_tol=1e-12)


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")):
        torch.zeros(64, 64) @ torch.zeros(64, 64)
    trace = tmp_path / "trace" / "trace.json"
    assert trace.exists() and "aten::mm" in trace.read_text()


def test_debug_nan_context_raises_on_a_nan_gradient():
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    # The gradient of sqrt at 0 is inf, and inf · 0 is NaN.
    torch.sqrt(x).mul(0.0).sum().backward()
    assert torch.isnan(x.grad).any()
    # Anomaly mode warns that it is on, and where the failing op was made.
    with pytest.warns(UserWarning), debug_nan_context():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).mul(0.0).sum().backward()
