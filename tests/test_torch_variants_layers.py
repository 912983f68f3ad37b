"""The generator variants' building blocks in the port against the JAX
package's, on the CPU: GMlp, PatchEmbed v1, the transposed conv and the v1
head alone against flax; SS2D and VSSBlock with dropout, the gated MLP and
post-norm; the dropout law; and the activation checkpoint of
MODEL.VSSM.USE_CHECKPOINT, which must give the gradients and masks of the
block without it. JAX params are carried across by flax_params_to_state_dict
and load_state_dict(strict=True); the same numpy inputs go through both."""

import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import flax.linen as fnn
import jax
import jax.numpy as jnp

from vm_asr_tpu.models import VSSBlock as JaxVSSBlock
from vm_asr_tpu.models import layers as jax_layers
from vm_asr_tpu.models import unet as jax_unet
from vm_asr_tpu_torch.compat import flax_params_to_state_dict
from vm_asr_tpu_torch.models import (
    ConvTranspose2d,
    Dropout,
    GMlp,
    Mlp,
    PatchEmbed,
    VSSBlock,
    init_parameters,
)
from vm_asr_tpu_torch.models.unet import HeadV1
from vm_asr_tpu_torch.ops.scan_api import SCAN_OUTPUT_OPS
from tests.torch_threads import one_torch_thread  # noqa: F401

# As tests/test_torch_model.py: fp32 maths in other orders, ~1e-6 of the
# output scale observed; a wiring fault moves the output by O(1).
FP32_REL = 1e-4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _flax_pair(jm, torch_module, x, prefix="", method=None, seed=0, wrap=None):
    """flax init and apply of ``jm`` on x, the params (under the flax module
    name ``wrap``, if given) loaded into the port's module (keys under
    ``prefix`` stripped); returns (JAX out, port out)."""
    xj = jnp.asarray(x)
    params = jm.init(jax.random.PRNGKey(seed), xj, method=method)["params"]
    ref = jm.apply({"params": params}, xj, method=method)
    tree = _np_tree(params) if wrap is None else {wrap: _np_tree(params)}
    sd = {k[len(prefix):]: v for k, v in flax_params_to_state_dict(tree).items()}
    torch_module.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = torch_module(torch.from_numpy(x))
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_gmlp_matches_flax(act):
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 16)).astype(np.float32)
    ref, got = _flax_pair(jax_layers.GMlp(hidden_features=24, out_features=16, act=act),
                          GMlp(16, 24, 16, act=act), x)
    assert got.shape == ref.shape == x.shape
    assert _rel(got, ref) < FP32_REL


@pytest.mark.parametrize("patch_size,hw,norm", [(4, (32, 32), True), (4, (16, 24), True),
                                                (2, (12, 10), False)])
def test_patch_embed_v1_matches_flax(patch_size, hw, norm):
    """One patch_size-strided conv and LN in slots 0 and 2."""
    x = np.random.default_rng(1).standard_normal((2, *hw, 1)).astype(np.float32)
    jm = jax_layers.PatchEmbed(embed_dim=16, patch_size=patch_size, version="v1",
                               patch_norm=norm)
    m = PatchEmbed(1, 16, patch_size, "v1", norm)
    ref, got = _flax_pair(jm, m, x, prefix="patch_embed.", wrap="patch_embed")
    assert sorted(m.state_dict()) == sorted(
        ["0.weight", "0.bias"] + (["2.weight", "2.bias"] if norm else []))
    assert got.shape == ref.shape == (2, -(-hw[0] // patch_size), -(-hw[1] // patch_size), 16)
    assert _rel(got, ref) < FP32_REL


@pytest.mark.parametrize("hw", [(5, 6), (8, 8)])
def test_conv_transpose_matches_flax(hw):
    """flax ConvTranspose(3, strides 2, SAME) is torch's transposed conv at
    padding 0 cropped to 2H×2W with the kernel flipped in both spatial axes
    and permuted to (in, out, kh, kw); the converter does the flip."""
    x = np.random.default_rng(2).standard_normal((1, *hw, 4)).astype(np.float32)
    jm = fnn.ConvTranspose(3, kernel_size=(3, 3), strides=(2, 2), padding="SAME",
                           kernel_init=jax_layers.torch_linear_init,
                           bias_init=fnn.initializers.normal(1.0))
    xj = jnp.asarray(x)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), xj)["params"])
    ref = np.asarray(jm.apply({"params": params}, xj))
    m = ConvTranspose2d(4, 3)
    # The converter maps a head's transposed conv by its name.
    sd = flax_params_to_state_dict({"out_convt1": params})
    m.load_state_dict({k.split(".", 2)[-1]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 2 * hw[0], 2 * hw[1], 3)
    assert _rel(got, ref) < FP32_REL
    # Neither the unflipped kernel nor torch's padding=1, output_padding=1 matches.
    w = torch.from_numpy(np.ascontiguousarray(params["kernel"].transpose(2, 3, 0, 1)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    b = torch.tensor(params["bias"])
    unflipped = torch.nn.functional.conv_transpose2d(xt, w, b, 2)[:, :, :2 * hw[0], :2 * hw[1]]
    padded = torch.nn.functional.conv_transpose2d(xt, m.weight.detach(), b, 2, 1, 1)
    for wrong in (unflipped, padded):
        assert _rel(wrong.permute(0, 2, 3, 1).numpy(), ref) > 0.1


@pytest.mark.parametrize("concat_skip", [True, False])
def test_v1_head_matches_flax(concat_skip):
    """The v1 head alone (JAX UNetCore.output at output_version v1): skip
    conv, GELU, two transposed convs, GELU between."""
    x = np.random.default_rng(3).standard_normal(
        (2, 8, 6, 32 if concat_skip else 16)).astype(np.float32)
    jm = jax_unet.UNetCore(dims=16, depths=(1, 1, 1, 1), output_version="v1",
                           concat_skip=concat_skip, scan_impl="ref")
    m = HeadV1(16, 1, concat_skip, torch.float32)
    ref, got = _flax_pair(jm, m, x, prefix="output_layer.",
                          method=lambda mod, v: mod.output(v))
    assert got.shape == ref.shape == (2, 32, 24, 1)
    assert _rel(got, ref) < FP32_REL


BLOCK_VARIANTS = {
    "gmlp": dict(gmlp=True),
    "drop_rates": dict(ssm_drop_rate=0.3, mlp_drop_rate=0.2),
    "gmlp_no_norm": dict(gmlp=True, use_norm=False),
}


@pytest.mark.parametrize("variant", sorted(BLOCK_VARIANTS))
def test_vss_block_variant_matches_jax(variant):
    """VSSBlock with the gated MLP, without norms, or with dropout (the
    identity in eval mode, as flax's deterministic=True), against the JAX
    block."""
    kw = BLOCK_VARIANTS[variant]
    x = np.random.default_rng(4).standard_normal((1, 16, 8, 16)).astype(np.float32)
    jm = JaxVSSBlock(hidden_dim=16, scan_impl="ref", **kw)
    m = VSSBlock(16, **kw).eval()
    ref, got = _flax_pair(jm, m, x, seed=1)
    assert _rel(got, ref) < FP32_REL


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_law(rate):
    """Training mode keeps each element with probability 1 − rate (within 3σ
    of a binomial count) and scales it by 1/(1 − rate); the same seed gives
    the same mask; eval mode and rate 0 are the identity."""
    d = Dropout(rate).train()
    x = torch.ones(200, 100)
    out = d(x, torch.Generator().manual_seed(3))
    kept = out != 0
    n, keep = x.numel(), 1 - rate
    assert abs(kept.sum().item() - n * keep) <= 3 * np.sqrt(n * keep * rate)
    assert torch.equal(out[kept], torch.full_like(out[kept], 1 / keep))
    assert torch.equal(out, d(x, torch.Generator().manual_seed(3)))
    with pytest.raises(ValueError, match="Generator"):
        d(x)
    assert torch.equal(d.eval()(x), x)
    assert torch.equal(Dropout(0.0).train()(x), x)


def test_mlp_dropout_draws_twice():
    """Mlp drops after the activation and after fc2 (two masks); in eval
    mode it is fc2(act(fc1(x)))."""
    m = Mlp(8, 32, 8, drop_rate=0.5)
    init_parameters(m, torch.Generator().manual_seed(0))
    x = torch.randn(4, 8)
    with torch.no_grad():
        plain = m.fc2(torch.nn.functional.gelu(m.fc1(x)))
        assert torch.equal(m.eval()(x), plain)
        g = torch.Generator().manual_seed(1)
        got = m.train()(x, g)
        g2 = torch.Generator().manual_seed(1)
        h = torch.nn.functional.gelu(m.fc1(x))
        h = torch.where(torch.rand(h.shape, generator=g2) < 0.5, h / 0.5, 0)
        y = m.fc2(h)
        want = torch.where(torch.rand(y.shape, generator=g2) < 0.5, y / 0.5, 0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _train_grads(block, x, seed):
    """One training-mode forward and backward; (output, input and parameter
    gradients, the generator's state after the forward)."""
    x = x.clone().requires_grad_(True)
    g = torch.Generator().manual_seed(seed)
    out = block(x, g)
    after = g.get_state()
    grads = torch.autograd.grad((out * torch.linspace(-1, 1, out.numel()).reshape(out.shape))
                                .sum(), [x] + list(block.parameters()))
    return out.detach(), grads, after


@pytest.mark.parametrize("kw", [dict(), dict(gmlp=True)])
def test_use_checkpoint_gives_the_same_gradients_and_masks(kw):
    """A training-mode block with DropPath and both dropouts, with and
    without the activation checkpoint, from one generator seed: the same
    output, bitwise-equal gradients (the recompute draws the masks of the
    first run), and the caller's generator left in the same state. Both
    scan routes (K·D 128 fused, K·D 64 the recurrence)."""
    for dim in (16, 8):
        x = torch.randn(2, 8, 8, dim, generator=torch.Generator().manual_seed(5))
        blocks = []
        for ckpt in (False, True):
            b = VSSBlock(dim, drop_path=0.4, ssm_drop_rate=0.2, mlp_drop_rate=0.3,
                         use_checkpoint=ckpt, **kw)
            init_parameters(b, torch.Generator().manual_seed(0))
            blocks.append(b.train())
        out0, g0, s0 = _train_grads(blocks[0], x, 11)
        out1, g1, s1 = _train_grads(blocks[1], x, 11)
        assert torch.equal(out0, out1) and torch.equal(s0, s1)
        for a, b in zip(g0, g1):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        out2, _, _ = _train_grads(blocks[1], x, 12)
        assert not torch.equal(out1, out2)  # the masks do come from the seed


def test_use_checkpoint_keeps_the_scan_output(monkeypatch):
    """The checkpoint's policy keeps the scan's output: the backward
    recomputes the block's other ops (here the in_proj) but runs the scan's
    forward only once (JAX: save_only_these_names("scan_out"))."""
    fused = importlib.import_module("vm_asr_tpu_torch.ops.selective_scan_fused")
    calls = {"scan": 0, "in_proj": 0}
    plain = fused.selective_scan_fused_plain

    def counted(*args):
        calls["scan"] += 1
        return plain(*args)

    monkeypatch.setattr(fused, "selective_scan_fused_plain", counted)
    for ckpt, want in ((False, dict(scan=1, in_proj=1)), (True, dict(scan=1, in_proj=2))):
        calls.update(scan=0, in_proj=0)
        b = VSSBlock(16, use_checkpoint=ckpt)
        init_parameters(b, torch.Generator().manual_seed(0))
        b.op.in_proj.register_forward_hook(lambda *_: calls.__setitem__(
            "in_proj", calls["in_proj"] + 1))
        x = torch.randn(1, 8, 8, 16, requires_grad=True)
        b.train()(x, torch.Generator()).sum().backward()
        assert calls == want, (ckpt, calls)
        # Without autograd the checkpoint is not taken.
        calls.update(scan=0, in_proj=0)
        with torch.no_grad():
            b(x, torch.Generator())
        assert calls == dict(scan=1, in_proj=1)


class _OpLog(TorchDispatchMode):
    """The dispatcher ops that reach the dispatch mode."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dim", [16, 8])  # the fused route (K·D 128), the recurrence (64)
@pytest.mark.parametrize("ckpt", [False, True])
def test_scan_route_follows_use_checkpoint(dim, ckpt):
    """A block's scans run as the dispatcher ops of SCAN_OUTPUT_OPS only
    when the block is checkpointed; every other block keeps the autograd
    Functions, which cost the host less per call."""
    b = VSSBlock(dim, use_checkpoint=ckpt)
    init_parameters(b, torch.Generator().manual_seed(0))
    x = torch.randn(1, 8, 8, dim, requires_grad=True)
    with _OpLog() as log:
        b.train()(x, torch.Generator()).sum().backward()
    used = {op for op in log.ops if op in SCAN_OUTPUT_OPS}
    assert bool(used) == ckpt, used
