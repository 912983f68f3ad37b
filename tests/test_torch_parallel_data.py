"""The data-parallel plumbing of the port on the CPU: the mesh and its
refusals, ``shard_batch`` and its replicate rule (against the JAX
package's), the pipelines' shards (their union is the one-process global
batch, and the JAX package's), the random draws of the global batch, and a
two-rank training run through the CLI (``--device cpu``, gloo) whose
rank-0 checkpoints load in one process, in the reference layout, and match
the same run in one process."""

import logging
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.data import DataPipeline as JaxDataPipeline
from vm_asr_tpu.data import DegradingSampler as JaxDegradingSampler
from vm_asr_tpu.data import SyntheticVCTK as JaxSyntheticVCTK
from vm_asr_tpu.parallel import make_mesh as jax_make_mesh
from vm_asr_tpu.parallel import shard_batch as jax_shard_batch
from vm_asr_tpu_torch import cli
from vm_asr_tpu_torch.compat import load_reference_checkpoint
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.data import (
    DataPipeline,
    DegradingSampler,
    SyntheticVCTK,
    WorkerPipeline,
    get_loaders,
)
from vm_asr_tpu_torch.models import DropPath, get_generator
from vm_asr_tpu_torch.parallel import Mesh, global_rows, make_mesh, pad_batch_to, shard_batch
from vm_asr_tpu_torch.train.steps import gp_alphas
from tests.test_torch_cli import CFG, TINY
from tests.torch_native import jax_uses_port_native  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401


def _batch(n):
    return {"wave_input": torch.arange(n * 6, dtype=torch.float32).reshape(n, 1, 6),
            "highcut": torch.arange(n)}


def test_shard_batch_takes_the_ranks_rows():
    for rank in (0, 1):
        got = shard_batch(_batch(4), Mesh(dp=2, mp=1, rank=rank))
        assert got["rows"] == (2 * rank, 4)
        assert torch.equal(got["wave_input"], _batch(4)["wave_input"][2 * rank:2 * rank + 2])
        assert torch.equal(got["highcut"], torch.arange(2 * rank, 2 * rank + 2))
    # dp 1 × mp 2: both ranks hold the whole batch.
    assert torch.equal(shard_batch(_batch(4), Mesh(dp=1, mp=2, rank=1))["highcut"],
                       torch.arange(4))


def test_shard_batch_replicates_an_uneven_batch(caplog):
    """A batch whose rows do not divide over dp stays whole on every rank,
    with the JAX package's warning, as its shard_batch keeps it whole."""
    # The port's logger may not propagate to the root logger (create_logger
    # sets it so): listen on it directly.
    logger = logging.getLogger("vm_asr_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger="vm_asr_tpu_torch"):
            got = shard_batch(_batch(3), Mesh(dp=2, mp=1, rank=1))
    finally:
        logger.removeHandler(caplog.handler)
    assert got["rows"] == (0, 3) and torch.equal(got["highcut"], torch.arange(3))
    assert "leading dim 3 not divisible by dp=2" in caplog.text
    mesh = jax_make_mesh(dp=2, devices=jax.devices()[:2])
    ref = jax_shard_batch({"highcut": jnp.arange(3)}, mesh)["highcut"]
    assert ref.sharding.is_fully_replicated


def test_pad_batch_to():
    x = np.ones((3, 2), np.float32)
    padded, n = pad_batch_to(x, 2)
    assert n == 3 and padded.shape == (4, 2) and not padded[3].any()
    assert pad_batch_to(x, 3)[0] is x


def test_make_mesh_needs_the_ranks():
    """One process and no group: a 1 × 1 mesh, and dp·mp beyond the one
    rank present raises, as JAX's reshape of too few devices does."""
    mesh = make_mesh()
    assert (mesh.dp, mesh.mp, mesh.dp_group, mesh.mp_group) == (1, 1, None, None)
    for dp, mp in ((2, 1), (1, 2)):
        with pytest.raises(ValueError, match=f"needs {dp * mp} ranks; 1 present"):
            make_mesh(dp, mp)
    with pytest.raises(ValueError):
        jax_make_mesh(dp=16, devices=jax.devices())


def test_cli_refuses_more_ranks_than_devices(tmp_path, monkeypatch):
    """MESH.DP 2 on a machine with one card raises before a rank starts,
    and MESH.DP -1 there is one process; on the CPU, -1 is one process and
    n is n ranks over gloo."""
    import vm_asr_tpu_torch.core as core

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(core, "resolve_device", torch.device)
    argv = ["--cfg", CFG, "--synthetic_data", "--opts", "MESH.DP", "2", "OUTPUT",
            str(tmp_path), *TINY]
    with pytest.raises(ValueError, match="MESH.DP 2 needs 2 CUDA devices; 1 present"):
        cli.run(argv)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert [cli.train_ranks(n, cuda) for n in (-1, 1)] == [1, 1]
    assert [cli.train_ranks(n, cpu) for n in (-1, 1, 2, 3)] == [1, 1, 2, 3]
    with pytest.raises(ValueError, match="at least 1"):
        cli.train_ranks(0, cpu)


def _cfg(c):
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = 0.126
    c.DATA.STFT.N_FFT = 128
    c.DATA.RANDOM_RESAMPLE = [4000, 16000]
    return c


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("cls", [DataPipeline, WorkerPipeline], ids=["threads", "worker"])
def test_pipeline_shards_make_the_global_batch(cls, shuffle):
    """Two shards at batch 2: each global batch's shards, rank order, are
    bitwise the batch of 4 that the JAX package's pipeline (and so the
    port's, tests/test_torch_worker_pipeline.py) reads in one process, over
    two epochs; the shards read disjoint items."""
    sampler = DegradingSampler(SyntheticVCTK(n_items=11, sr=16000, duration=0.2),
                               _cfg(default_config()), training=True)
    jax_sampler = JaxDegradingSampler(JaxSyntheticVCTK(n_items=11, sr=16000, duration=0.2),
                                      _cfg(jax_default_config()), training=True)
    kw = dict(seed=7, shuffle=shuffle)
    shards = [cls(sampler, batch_size=2, shard_index=s, shard_count=2, num_workers=2, **kw)
              for s in range(2)]
    one = JaxDataPipeline(jax_sampler, batch_size=4, num_workers=2, **kw)
    for epoch in (0, 1):
        for p in (*shards, one):
            p.set_epoch(epoch)
        got = [list(p) for p in shards]
        want = list(one)
        assert len(shards[0]) == len(one) == len(want) == 2  # 11 // 4, the last 3 dropped
        for bi, w in enumerate(want):
            parts = [got[s][bi] for s in range(2)]
            for field in ("wave_input", "wave_target", "highcut", "pad_lengths"):
                np.testing.assert_array_equal(
                    np.concatenate([getattr(p, field) for p in parts]), getattr(w, field))
            assert parts[0].names + parts[1].names == w.names
            assert not set(parts[0].names) & set(parts[1].names)


def test_sharded_pipeline_refuses_a_partial_last_batch():
    sampler = DegradingSampler(SyntheticVCTK(n_items=4, sr=16000, duration=0.2),
                               _cfg(default_config()), training=True)
    for cls in (DataPipeline, WorkerPipeline):
        with pytest.raises(ValueError, match="drop_last"):
            cls(sampler, batch_size=1, shard_index=0, shard_count=2, drop_last=False)
        with pytest.raises(ValueError, match="shard_index"):
            cls(sampler, batch_size=1, shard_index=2, shard_count=2)


def test_get_loaders_shards_the_training_batches():
    """A rank's training pipeline reads DATA.BATCH_SIZE / dp rows of each
    global batch; validation reads whole batches (the Trainer cuts them);
    a batch that does not divide over dp is read whole on every rank."""
    c = _cfg(default_config())
    c.DATA.BATCH_SIZE = 4
    ds = SyntheticVCTK(n_items=20, sr=16000, duration=0.2)
    train, valid = get_loaders(c, dataset=ds, shard_index=1, shard_count=2)
    assert (train.batch_size, train.shard_index, train.shard_count) == (2, 1, 2)
    assert (valid.batch_size, valid.shard_count) == (4, 1)
    assert len(train) == len(get_loaders(c, dataset=ds)[0])  # one batch a global step
    c.DATA.BATCH_SIZE = 3
    train, _ = get_loaders(c, dataset=ds, shard_index=1, shard_count=2)
    assert (train.batch_size, train.shard_count) == (3, 1)


def test_draws_are_the_global_batchs():
    """DropPath's masks and the penalty's interpolation weights, drawn for
    rows 2-3 of a global batch of 4, are rows 2-3 of the whole batch's
    draws from the same generator."""
    x = torch.ones(4, 3, 2, 5)
    drop = DropPath(0.5).train()
    whole = drop(x, torch.Generator().manual_seed(1))
    with global_rows(2, 4):
        part = drop(x[2:], torch.Generator().manual_seed(1))
        alphas = gp_alphas(torch.Generator().manual_seed(2), 2, 2)
    assert torch.equal(part, whole[2:])
    assert all(torch.equal(a, w[2:]) for a, w in
               zip(alphas, gp_alphas(torch.Generator().manual_seed(2), 4, 2)))
    with pytest.raises(ValueError, match="outside a global batch"):
        with global_rows(3, 4):
            drop(x[2:], torch.Generator())


def _train(out, ranks):
    return cli.run(["--cfg", CFG, "--tag", "t", "--input_sr", "8000", "--synthetic_data",
                    "--synthetic_n", "10", "--batch_size", "2", "--device", "cpu",
                    "--opts", "TRAIN.EPOCHS", "1", "OUTPUT", str(out), "MESH.DP", str(ranks),
                    "DATA.VALID_SPLIT", "0.2", *TINY[:-6], "DATA.NUM_WORKERS", "1",
                    "TENSORBOARD.ENABLE", "False"])


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    """One epoch of the tiny CLI run (8 training items: 4 global batches of
    2, one validation batch of 2) on two ranks and in one process."""
    out = tmp_path_factory.mktemp("dp2")
    mode, result = _train(out / "dp2", 2)
    assert (mode, result) == ("train", {"ranks": 2})
    _, one = _train(out / "one", 1)
    return out / "dp2" / "DualStreamInteractiveMambaUNet" / "t", one


def test_two_rank_checkpoint_loads_in_one_process(two_rank_run):
    """Rank 0 wrote every checkpoint, in the reference layout (the
    module's own names, no ``module.``; the blob of
    scripts/jax_checkpoint_to_pth.py), and one process loads it; rank 0
    alone wrote the log."""
    run_dir, one = two_rank_run
    assert sorted(p.name for p in run_dir.glob("*.pth")) == [
        f"checkpoint-{k}-{m}.pth" for k in ("best", "latest") for m in ("G", "mpd")]
    assert not list(run_dir.glob("*.tmp*"))
    assert sorted(p.name for p in run_dir.glob("log*")) == ["log_rank0.txt"]
    for tag, module in (("G", one.generator), ("mpd", one.discriminators["mpd"])):
        blob = torch.load(run_dir / f"checkpoint-latest-{tag}.pth", weights_only=True)
        assert set(blob) == {"state_dict", "optimizer", "step", "epoch", "monitor_best", "config"}
        assert set(blob["state_dict"]) == set(module.state_dict())
        assert (blob["epoch"], blob["step"], blob["optimizer"]["count"]) == (0, 4, 4)
    gen = get_generator(one.config, "cpu", seed=123)  # other weights until loaded
    load_reference_checkpoint(gen, str(run_dir / "checkpoint-best-G.pth"))
    best = torch.load(run_dir / "checkpoint-best-G.pth", weights_only=True)["state_dict"]
    assert all(torch.equal(v, best[k]) for k, v in gen.state_dict().items())


def test_two_rank_run_matches_one_process(two_rank_run):
    """The two ranks' epoch is the one process's: the same monitored
    training LSD (4e-8 apart observed), and parameters within a fraction of
    one AdamW step (lr per element) of each other after the four steps:
    each step's gradients agree to fp32 rounding (tests/
    test_torch_parallel_step.py), and AdamW, which divides by |g|, turns
    rounding in small gradients into parts of a step (observed: at most
    0.084·lr, 0.06 % of elements above 0.05·lr). Ranks that stepped on their
    own rows, unaveraged, would move many elements by about lr a step."""
    run_dir, one = two_rank_run
    blob = torch.load(run_dir / "checkpoint-latest-G.pth", weights_only=True)
    assert math.isclose(blob["monitor_best"], one.mnt_best, rel_tol=1e-5)
    lr = one.config.TRAIN.BASE_LR
    got, ref = blob["state_dict"], one.generator.state_dict()
    diff = np.concatenate([(got[k] - ref[k]).abs().numpy().ravel() for k in ref]) / lr
    assert diff.max() <= 0.5 and (diff > 0.05).mean() <= 1e-2, \
        (diff.max(), (diff > 0.05).mean())
