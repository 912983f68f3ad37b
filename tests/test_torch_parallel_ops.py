"""The port's ``mp`` split, sequence-sharded scan and data-parallel spectral
convergence on two gloo ranks on the CPU, against the port in one process
and against the JAX package on virtual CPU devices.

- The ``mp`` split (models/ss2d.py): tests/test_mp.py's tiny model and
  inputs, each SS2D's K directions split over the two ranks (dp 1 × mp 2),
  forward and every gradient leaf against the unsplit model and against
  the JAX model under its dp 2 × mp 2 mesh, at test_mp.py's bars.
- ``seq_sharded_selective_scan`` over the two ranks, value and gradients,
  against the one-device scan and the JAX package's seq-sharded scan (mp 2),
  at tests/test_seq_scan.py's bars: a long L (1024 steps a shard, where the
  masked lanes' exponent would overflow exp()) on the recurrence route, and
  K·D 128 on the fused route.
- The spectral convergence of rows whose norms differ 10× between the
  ranks, value and gradient, against the global batch's.
All cases run on one pair of ranks, started once for the module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu.compat.torch_port import state_dict_to_flax
from vm_asr_tpu.models.unet import DualStreamInteractiveMambaUNet as JaxDualStream
from vm_asr_tpu.ops.seq_scan import seq_sharded_selective_scan as jax_seq_scan
from vm_asr_tpu.parallel import make_mesh as jax_make_mesh
from vm_asr_tpu.parallel import set_activation_mesh as jax_set_activation_mesh
from vm_asr_tpu.parallel import shard_batch as jax_shard_batch
from vm_asr_tpu_torch.compat import flax_params_to_state_dict
from vm_asr_tpu_torch.losses import spectral_convergence_loss
from vm_asr_tpu_torch.ops import scan_api, selective_scan
from tests import torch_parallel as tp
from tests.torch_threads import one_torch_thread  # noqa: F401

# tests/test_mp.py's bars: forward rtol = atol = 1e-5; gradients rtol 2e-4,
# atol 2e-5.
MP_FWD, MP_GRAD = dict(rtol=1e-5, atol=1e-5), dict(rtol=2e-4, atol=2e-5)
# tests/test_seq_scan.py's bars: value rtol = atol = 2e-4; gradients through
# the fused route rtol = atol = 2e-3.
SEQ_VALUE, SEQ_GRAD = dict(rtol=2e-4, atol=2e-4), dict(rtol=2e-3, atol=2e-3)
# The spectral convergence: fp32 sums in another order.
SC_REL = 1e-6
CASES = ["mp:split"] + [f"seq:{c}" for c in tp.SEQ_CASES] + ["sc:rows"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_ops")
    torch.save(dict(state=tp.mp_model().state_dict()), tp.spec_path(tmp, "mp:split"))
    for case in CASES[1:]:
        torch.save({}, tp.spec_path(tmp, case))
    return tp.launch(CASES, tmp)


@pytest.fixture(scope="module")
def mp_refs():
    """The port's unsplit run, and the JAX model's forward and gradients
    under a dp 2 × mp 2 mesh (tests/test_mp.py's), from the same weights."""
    state = tp.mp_model().state_dict()
    one = tp.run_mp(dict(state=state))
    model = JaxDualStream(depths=(1, 1, 1, 1), dims=4, n_fft=64, hop_length=16, win_length=64,
                          drop_path_rate=0.0)
    params = jax.tree_util.tree_map(
        jnp.asarray, state_dict_to_flax({k: v.numpy() for k, v in state.items()}))
    x, y, hf = tp.mp_inputs()
    mesh = jax_make_mesh(dp=2, mp=2, devices=jax.devices()[:4])
    jax_set_activation_mesh(mesh)
    try:
        xs = jax_shard_batch({"x": jnp.asarray(x), "y": jnp.asarray(y),
                              "hf": jnp.asarray(hf.astype(np.int32))}, mesh)

        def loss(p):
            out = model.apply({"params": p}, xs["x"], xs["hf"], deterministic=True)
            return jnp.mean((out - xs["y"]) ** 2), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        out, grads = np.array(out), jax.tree_util.tree_map(np.array, grads)
    finally:
        jax_set_activation_mesh(None)
    return one, dict(out=torch.from_numpy(out), grads=flax_params_to_state_dict(grads))


def _close(got, ref, tol, what):
    torch.testing.assert_close(got, ref, **tol, msg=lambda m: f"{what}: {m}")


def test_mp_ranks_agree(ranks):
    """Both ranks of the mp group hold the whole output and every whole
    gradient, bitwise alike (the K-sliced parameters' as much as the
    replicated ones')."""
    r0, r1 = ranks["mp:split"]
    assert torch.equal(r0["out"], r1["out"])
    for k, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][k]), k


@pytest.mark.parametrize("ref", ["one_process", "jax"])
def test_mp_forward_and_gradients(ranks, mp_refs, ref):
    got = ranks["mp:split"][0]
    want = mp_refs[0] if ref == "one_process" else mp_refs[1]
    _close(got["out"], want["out"], MP_FWD, "forward")
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        _close(got["grads"][k], g, MP_GRAD, k)
    # Every SS2D parameter, K-sliced ones included, has its whole gradient.
    for k, g in got["grads"].items():
        if ".op." in k:
            assert float(g.abs().max()) > 0, k


def test_split_keeps_the_global_width_route(monkeypatch):
    """A rank's share of K·D = 128 (2 directions of 32) stays on the fused
    route when the call passes the global width, as the JAX package's gate
    reads the global K·D; its own width alone would take the recurrence."""
    calls = []
    real = scan_api.selective_scan_fused
    monkeypatch.setattr(scan_api, "selective_scan_fused",
                        lambda *a, **kw: calls.append("fused") or real(*a, **kw))
    args, _ = tp.seq_inputs("fused")
    half = [torch.from_numpy(a[..., :2, :] if a.ndim == 4 else a[:2]) for a in args]
    y = selective_scan(*half, lanes=128)
    assert calls == ["fused"] and y.shape == half[0].shape
    selective_scan(*half)
    assert calls == ["fused"]  # K·D 64 alone: the recurrence


def _seq_refs(case):
    """The one-device port scan and the JAX seq-sharded scan (mp 2): y and
    the gradients of Σ y·w."""
    args, w = tp.seq_inputs(case)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = selective_scan(*ts)
    one = dict(y=y.detach(), grads=dict(zip(tp.SEQ_NAMES, torch.autograd.grad(
        (y * torch.from_numpy(w)).sum(), ts))))
    mesh = jax_make_mesh(dp=1, mp=2, devices=jax.devices()[:2])

    def loss(*a):
        y = jax_seq_scan(*a, mesh=mesh, axis="mp", impl="ref")
        return jnp.sum(y * w), y

    (_, y_j), grads_j = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(7)), has_aux=True))(
        *[jnp.asarray(a) for a in args])
    return one, dict(y=torch.from_numpy(np.array(y_j)),
                     grads={k: torch.from_numpy(np.array(g)) for k, g in zip(tp.SEQ_NAMES, grads_j)})


def _gathered(ranks_out):
    """The ranks' shards joined along L; A, D and bias gradients are the
    whole sequence's on every rank."""
    r0, r1 = ranks_out
    y = torch.cat([r0["y"], r1["y"]], dim=1)
    grads = {}
    for k in tp.SEQ_NAMES:
        if k in tp.SHARDED:
            grads[k] = torch.cat([r0["grads"][k], r1["grads"][k]], dim=1)
        else:
            assert torch.equal(r0["grads"][k], r1["grads"][k]), k
            grads[k] = r0["grads"][k]
    return y, grads


@pytest.mark.parametrize("case", sorted(tp.SEQ_CASES))
def test_seq_sharded_scan(ranks, case):
    y, grads = _gathered(ranks[f"seq:{case}"])
    for ref in _seq_refs(case):
        _close(y, ref["y"], SEQ_VALUE, f"{case} y")
        for k in tp.SEQ_NAMES:
            assert bool(torch.isfinite(grads[k]).all()), k
            _close(grads[k], ref["grads"][k], SEQ_GRAD, f"{case} d{k}")


def test_spectral_convergence_sums_over_ranks(ranks):
    """Value and gradient are the global batch's; the plain per-rank ratios
    (whose mean a data-parallel step would otherwise take) are far from it."""
    x, y = (torch.from_numpy(a) for a in tp.sc_inputs())
    xm = x.clone().requires_grad_(True)
    sc = spectral_convergence_loss(xm, y)
    (g,) = torch.autograd.grad(sc, xm)
    r0, r1 = ranks["sc:rows"]
    for r in (r0, r1):
        assert abs(float(r["sc"]) - float(sc)) <= SC_REL * float(sc)
    # Each rank's rows carry the global loss's gradient, scaled by dp (the
    # step then averages the gradients over dp).
    got = torch.cat([r0["grad"], r1["grad"]]) / tp.WORLD
    torch.testing.assert_close(got, g, rtol=1e-5, atol=1e-9)
    per_rank_mean = (float(r0["local"]) + float(r1["local"])) / 2
    assert abs(per_rank_mean - float(sc)) > 100 * SC_REL * float(sc)
