"""The port's half of the trajectory check (vm_asr_tpu_torch/trajectory.py)
on the CPU, against the JAX Trainer's recording in artifacts/trajectory_torch
(written by scripts/torch_trajectory_record.py): the recording carries over
into the port's generator and MPD by name, one epoch of the port's Trainer
lands within the no-GAN bars of the JAX curve's first row, the defect the
gates must catch breaks them, a gate is a column's bar or its largest
recorded chaos floor, whichever is larger, and an arm fails when the defect
breaks no gate."""

import numpy as np
import pytest
import torch

from vm_asr_tpu_torch import trajectory

from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def data():
    return trajectory.load_artifact()


def test_the_recording(data):
    batches, (vi, vt, vhc), init, curves = data
    assert len(batches) == 8
    for inp, tgt, hc in batches:
        assert inp.shape == tgt.shape == (4, 1, trajectory.SAMPLES) and hc.shape == (4,)
    assert vi.shape == vt.shape == (4, 1, trajectory.SAMPLES)
    assert {k.split(":")[0] for k in init} == {"gen", "mpd"}
    assert [len(curves[arm]) for arm in ("nogan", "gan")] == [12, 12]
    assert list(curves["gan"][0]) == ["epoch", "total_loss", "val_lsd", "disc_loss", "adv"]
    assert all(np.isfinite(v) for rows in curves.values() for r in rows for v in r.values())


def test_the_jax_init_loads_into_the_port_by_name(data):
    """run_arm loads the generator and the MPD with strict=True: no key of
    either side is left over; zero epochs train nothing."""
    assert trajectory.run_arm(True, 0, "cpu", data) == []


@pytest.fixture(scope="module")
def one_epoch(data):
    """One no-GAN epoch of the port and of the defect: their worst gaps to
    the JAX curve's first row."""
    ref = data[3]["nogan"][:1]
    return {name: trajectory.worst_gaps(trajectory.run_arm(False, 1, "cpu", data, **kw), ref)
            for name, kw in (("port", {}), ("defect", {"overrides": trajectory.DEFECT}))}


def test_one_epoch_within_the_nogan_bars(one_epoch):
    gaps = one_epoch["port"]
    assert gaps["total_loss"] <= trajectory.BARS["nogan"]["total_loss"], gaps
    assert gaps["val_lsd"] <= trajectory.BARS["nogan"]["val_lsd"], gaps


def test_the_defect_breaks_the_nogan_bars(one_epoch):
    """After one epoch half the learning rate already breaks the total-loss
    bar, and lies further from JAX than the port in both columns."""
    port, defect = one_epoch["port"], one_epoch["defect"]
    assert "total_loss" in trajectory.broken(defect, trajectory.BARS["nogan"]), defect
    assert all(defect[k] > port[k] for k in port), (defect, port)


def test_the_gates_are_the_bars_or_the_recorded_floors():
    """Fixed numbers: each barred column's bar, or its largest recorded
    floor where that lies above the bar."""
    for arm, bars in trajectory.BARS.items():
        gate = trajectory.gates(arm)
        for k, bar in bars.items():
            median, largest = trajectory.RECORDED_FLOORS[arm][k]
            assert 0 < median <= largest, (arm, k)
            assert gate[k] == max(bar, largest)
            assert (k in trajectory.bars_below_floor(arm)) == (largest > bar)


def test_an_arm_fails_over_a_gate_or_when_the_defect_passes():
    gate = trajectory.gates("gan")
    inside = {k: 0.5 * g for k, g in gate.items()}
    over = {k: 2.0 * g for k, g in gate.items()}
    assert trajectory.judge("gan", inside, over)["ok"]
    assert trajectory.judge("gan", over, over)["broken"] == list(gate)
    verdict = trajectory.judge("gan", inside, inside)
    assert not verdict["caught"] and not verdict["ok"]
    one = dict(inside, total_loss=over["total_loss"])
    assert trajectory.judge("gan", inside, one)["defect_broken"] == ["total_loss"]


def test_perturb_moves_the_share_it_names():
    model = torch.nn.Linear(400, 500)
    before = model.weight.detach().clone()
    trajectory.perturb(model, seed=0)
    moved = (model.weight - before).abs()
    share = (moved > 0).float().mean().item()
    assert 0.5 * trajectory.PERTURB_SHARE < share < 2 * trajectory.PERTURB_SHARE
    assert torch.allclose(moved[moved > 0], torch.tensor(trajectory.PERTURB_BY), atol=1e-6)


def test_main_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: trajectory.main would train on the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trajectory.main(["--epochs", "1"])
