"""The port's worker-process pipeline (data/worker_pipeline.py, DATA.PIPELINE
grain) on the CPU: bitwise the threads pipeline, and so the JAX package's
DataPipeline, at shard_count 1 over two epochs; the contract of the JAX
package's GrainPipeline (tests/test_grain_pipeline.py); a worker's error
raised in the consumer; no worker left alive after an epoch stopped early.
"""

import multiprocessing
import threading

import numpy as np
import pytest

from vm_asr_tpu.core import default_config as jax_default_config
from vm_asr_tpu.data import DataPipeline as JaxDataPipeline
from vm_asr_tpu.data import DegradingSampler as JaxDegradingSampler
from vm_asr_tpu.data import SyntheticVCTK as JaxSyntheticVCTK
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.data import (
    DataPipeline,
    DegradingSampler,
    SyntheticVCTK,
    WorkerPipeline,
    get_loaders,
)
from tests.torch_native import jax_uses_port_native  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401


def _cfg(c):
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = 0.126
    c.DATA.STFT.N_FFT = 128
    c.DATA.RANDOM_RESAMPLE = [4000, 16000]
    return c


def _sampler(n=10, dataset=SyntheticVCTK, sampler=DegradingSampler, cfg=default_config):
    return sampler(dataset(n_items=n, sr=16000, duration=0.2), _cfg(cfg()), training=True)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for field in ("wave_input", "wave_target", "highcut", "pad_lengths"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert g.names == w.names


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("drop_last", [True, False])
def test_bitwise_threads_and_jax_pipelines(workers, drop_last):
    """shard_count 1: the worker pipeline's batches are the threads
    pipeline's and the JAX DataPipeline's, bit for bit, epochs 0 and 1."""
    kw = dict(batch_size=4, indices=list(range(1, 11)), seed=5, drop_last=drop_last)
    pipe = WorkerPipeline(_sampler(11), num_workers=workers, **kw)
    threads = DataPipeline(_sampler(11), num_workers=2, **kw)
    ref = JaxDataPipeline(_sampler(11, JaxSyntheticVCTK, JaxDegradingSampler,
                                   jax_default_config), num_workers=2, **kw)
    assert len(pipe) == len(threads) == len(ref) == (2 if drop_last else 3)
    for epoch in (0, 1):
        for p in (pipe, threads, ref):
            p.set_epoch(epoch)
        got = list(pipe)
        _assert_batches_equal(got, list(threads))
        _assert_batches_equal(got, list(ref))


def test_shapes_and_len():
    pipe = WorkerPipeline(_sampler(), batch_size=4, num_workers=0)
    assert len(pipe) == 2
    batches = list(pipe)
    assert len(batches) == 2
    b = batches[0]
    assert b.wave_input.shape == b.wave_target.shape == (4, 1, 2016)
    assert b.highcut.shape == (4,) and b.highcut.dtype == np.int32 and len(b.names) == 4
    assert not np.allclose(b.wave_input, b.wave_target)


def test_epoch_determinism_and_reshuffle():
    pipe = WorkerPipeline(_sampler(), batch_size=4, num_workers=0, seed=7)
    b0 = list(pipe)[0]
    np.testing.assert_array_equal(b0.wave_input, list(pipe)[0].wave_input)
    pipe.set_epoch(1)
    assert not np.array_equal(b0.wave_input, list(pipe)[0].wave_input)


def test_multiprocess_workers():
    pipe = WorkerPipeline(_sampler(), batch_size=4, num_workers=2)
    batches = list(pipe)
    assert len(batches) == 2 and np.isfinite(batches[0].wave_input).all()
    _assert_batches_equal(batches, list(WorkerPipeline(_sampler(), batch_size=4,
                                                       num_workers=0)))


def test_drop_last_false():
    pipe = WorkerPipeline(_sampler(), batch_size=4, num_workers=2, drop_last=False,
                          shuffle=False)
    batches = list(pipe)
    assert len(pipe) == len(batches) == 3
    assert batches[-1].wave_input.shape[0] == 2
    assert [n for b in batches for n in b.names] == [f"synth_{i:04d}.wav"
                                                     for i in range(10)]


def test_multihost_sharding_partition_and_determinism():
    """Per-host pipelines with shard_index i of n read disjoint record sets
    of n_records // n each, per epoch, deterministic for a seed; every item
    draws the stream of its global position."""
    sampler = _sampler()  # 10 records
    n_hosts = 3

    def names_for(shard, epoch=0):
        pipe = WorkerPipeline(sampler, batch_size=1, num_workers=0, seed=11,
                              shard_index=shard, shard_count=n_hosts)
        pipe.set_epoch(epoch)
        assert len(pipe) == 3  # 10 // 3 records a host, batch 1
        return [b.names[0] for b in pipe]

    per_host = [names_for(i) for i in range(n_hosts)]
    flat = [n for names in per_host for n in names]
    assert len(flat) == len(set(flat)) == 9
    assert per_host[0] == names_for(0)
    e1 = [names_for(i, epoch=1) for i in range(n_hosts)]
    assert len({n for ns in e1 for n in ns}) == 9 and e1 != per_host

    # The hosts' batches, interleaved, are one host's epoch over all records.
    one = list(WorkerPipeline(sampler, batch_size=1, num_workers=0, seed=11,
                              indices=range(10), shard_count=1))[:9]
    shards = [list(WorkerPipeline(sampler, batch_size=1, num_workers=2, seed=11,
                                  shard_index=i, shard_count=n_hosts)) for i in range(n_hosts)]
    _assert_batches_equal([shards[p % n_hosts][p // n_hosts] for p in range(9)], one)


@pytest.mark.parametrize("index,count", [(2, 2), (-1, 2), (0, 0)])
def test_shard_index_validation(index, count):
    with pytest.raises(ValueError):
        WorkerPipeline(_sampler(), batch_size=1, shard_index=index, shard_count=count)


def test_loader_factory_grain():
    c = _cfg(default_config())
    c.DATA.BATCH_SIZE = 4
    c.DATA.NUM_WORKERS = 0
    c.DATA.PIPELINE = "grain"
    c.EVAL_MODE = False
    train, valid = get_loaders(c, dataset=SyntheticVCTK(n_items=10, sr=16000, duration=0.2))
    assert isinstance(train, WorkerPipeline) and isinstance(valid, WorkerPipeline)
    assert np.isfinite(next(iter(train)).wave_input).all()


class Broken(SyntheticVCTK):
    def load(self, i):
        if i == 5:
            raise ValueError("bad item")
        return super().load(i)


@pytest.mark.parametrize("workers", [0, 2])
def test_worker_error_raised_in_consumer(workers):
    """A sample that fails in a worker is raised to the consumer, which does
    not wait forever."""
    sampler = DegradingSampler(Broken(n_items=9, sr=16000, duration=0.15),
                               _cfg(default_config()))
    pipe = WorkerPipeline(sampler, batch_size=2, shuffle=False, num_workers=workers)
    result, before = {}, _children()

    def consume():
        try:
            result["n"] = sum(1 for _ in pipe)
        except ValueError as e:
            result["error"] = str(e)

    t = threading.Thread(target=consume)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and set(result) == {"error"} and "bad item" in result["error"]
    assert not _children() - before


def _children():
    return set(multiprocessing.active_children())


def test_early_stop_leaves_no_live_worker():
    before = _children()  # processes an earlier test module may have left
    pipe = WorkerPipeline(_sampler(40), batch_size=2, num_workers=3)
    it = iter(pipe)
    next(it)
    workers = _children() - before
    assert len(workers) == 3
    it.close()  # the consumer leaves the epoch after one batch
    assert not _children() - before
    assert all(not w.is_alive() for w in workers)
    for _ in pipe:  # the next epoch starts new workers
        break
    assert not _children() - before
