"""Whole runs of each kind of cell on the CPU, at a size a CPU holds and in
float32 (so that a sound program reads as the reference does): the run
without its look for a card. A sound run comes out correct; each fault
that the cell can have, planted in the timed path underneath, makes
``correct`` come out false under the cell's own limits."""

import time

import pytest
import torch

from benchmark.harness import run_cell

T_SEG = 63 * 240 / 48000  # a 256 × 64 image at n_fft 512, hop 240
TINY = {"program": {"MODEL": {"VSSM": {"DIMS": 8, "DEPTHS": [1, 1, 1, 1]}},
                    "DATA": {"SEGMENT": T_SEG, "STFT": {"N_FFT": 512, "WIN_LENGTH": 512}},
                    "TRAIN": {"ADVERSARIAL": {"MPD_HIDDEN": 2, "MPD_PERIODS": [2, 3]}},
                    "AMP_ENABLE": False},
        "mix": {"pool": 4, "length": {"dist": "uniform", "min_s": 0.3, "max_s": 1.0},
                "sample": 3, "batch": 2, "warmup_steps": 1, "profile_requests": 2,
                "profile_steps": 1}}
SERVE = "vmasr48k_d16.serve_vctk"
TRAIN = "vmasr48k_d16.train_b4"


def _run(cell, fault=None, trace=False):
    return run_cell(cell, 2**31 + 5, 1.0, trace, time.perf_counter(), device="cpu",
                    fault=fault, overrides=TINY)


def _altered(job):
    fwd = job.inferencer.forward
    job.inferencer.forward = lambda x, hf: fwd(x, hf) * 1.1


def _half_rows(job):
    fwd = job.inferencer.forward

    def half(x, hf):
        out = fwd(x, hf)
        if x.shape[0] > 1:
            k = x.shape[0] // 2
            out = torch.cat([out[:k], out[:k], out[:x.shape[0] - 2 * k]])
        return out

    job.inferencer.forward = half


def _still(job):
    for state in [job.trainer.gen_state, *job.trainer.disc_states.values()]:
        state.optimizer.apply = lambda grads: False


def _half_batch(job):
    step = job.step_fn

    def half(gen_state, disc_states, batch, rng):
        k = batch["wave_input"].shape[0] // 2
        return step(gen_state, disc_states, {key: v[:k] for key, v in batch.items()}, rng)

    job.step_fn = half


class _NoGrad(torch.autograd.Function):
    """The identity forward, no gradient back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def _scan_bwd(monkeypatch):
    """A fault of the scan's backward alone: no gradient reaches B and C
    (the fused backward's dB and dC), so x_proj's B and C rows stay still
    while the forward is exact."""
    from vm_asr_tpu_torch.models import ss2d

    scan = ss2d.selective_scan

    def faulty(u, dts, A, Bs, Cs, *args, **kwargs):
        return scan(u, dts, A, _NoGrad.apply(Bs), _NoGrad.apply(Cs), *args, **kwargs)

    def plant(job):
        monkeypatch.setattr(ss2d, "selective_scan", faulty)

    return plant


def _drawn_otherwise(job):
    """Not a fault: the program draws its DropPath masks from a generator
    seeded otherwise, as a change to how it consumes its random numbers
    would; the check takes the masks it drew and stays correct."""
    step = job.step_fn
    other = torch.Generator().manual_seed(12345)

    def drawn(gen_state, disc_states, batch, rng):
        return step(gen_state, disc_states, batch, other)

    job.step_fn = drawn


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("cell,fault", [(SERVE, _altered), (SERVE, _half_rows),
                                        (TRAIN, _still), (TRAIN, _half_batch)],
                         ids=["serve-answer-altered", "serve-half-batch", "train-state-unchanged",
                              "train-half-batch"])
def test_fault_is_not_correct(cell, fault):
    r = _run(cell, fault)
    assert not r["correct"], r["checks"]


def test_masks_drawn_otherwise_are_correct():
    r = _run(TRAIN, _drawn_otherwise)
    assert r["correct"], r["checks"]
    assert r["checks"]["mask_misses"]["value"] == 0


def test_scan_backward_fault_is_not_correct(monkeypatch):
    r = _run(TRAIN, _scan_bwd(monkeypatch))
    assert not r["correct"], r["checks"]
    c = r["checks"]
    assert c["scan_grad_gap"]["value"] > c["scan_grad_gap"]["limit"], c
