"""The classification cell on the CPU at a size a CPU holds (dims 16,
depths 1-1-2-1, 32² images, batch 4): a sound run is correct, traced and
not; a fault of the scan route planted in the served model (a state
channel dropped, or the D·u skip) fails the cell's own limit; the fp8
control reads above the limits and the program (bf16, as the configuration
states) below them; and the parent's tree, which lacks the classifier's
configuration keys, fails at once."""

import functools
import time

import pytest
import torch

from benchmark.controls_classify import readings
from benchmark.harness import cell_spec, run_cell

CELL = "vssm_tiny.classify"
TINY = {"program": {"MODEL": {"NUM_CLASSES": 10, "VSSM": {"DIMS": 16, "DEPTHS": [1, 1, 2, 1]}},
                    "DATA": {"IMG_SIZE": 32}},
        "mix": {"batch": 4, "pool": 2, "check_rows": 3, "profile_requests": 1}}
CONTROL = {**TINY, "program": {**TINY["program"], "DATA": {"IMG_SIZE": 64}}}
FP32 = {**TINY, "program": {**TINY["program"], "AMP_ENABLE": False}}


def _run(fault=None, trace=False, overrides=FP32):
    return run_cell(CELL, 2**31 + 5, 1.0, trace, time.perf_counter(), device="cpu",
                    fault=fault, overrides=overrides)


def _route_fault(kind: str):
    """A fault of the general-N route, planted in the served model: y
    without its D·u term, or without one state channel's C·h (the first,
    the slowest to decay, or the last)."""
    from vm_asr_tpu_torch.models import ss2d

    def faulty(scan, u, dts, A, Bs, Cs, D_skip, *args, **kwargs):
        if kind == "no_d_skip":
            D_skip = torch.zeros_like(D_skip)
        else:
            Cs = Cs.clone()
            Cs[..., 0 if kind == "first_state_dropped" else -1] = 0
        return scan(u, dts, A, Bs, Cs, D_skip, *args, **kwargs)

    def plant(job, monkeypatch):
        monkeypatch.setattr(ss2d, "selective_scan", functools.partial(faulty, ss2d.selective_scan))

    return plant


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_sound_run_is_correct(trace):
    r = _run(trace=trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"logit_gap", "state_gap", "top5_misses"}
    if trace:  # on the CPU only the program's spans read: no device events
        assert set(r["metrics"]) == {"classifier_idle_ms.classify", "load_host_ms.classify"}
    else:
        assert set(r["metrics"]) == {"serve_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["no_d_skip", "first_state_dropped", "last_state_dropped"])
def test_scan_fault_is_not_correct(monkeypatch, fault):
    """Each fault fails ``state_gap``, the route against the reference's
    scan on its own inputs, whatever the logits show."""
    plant = _route_fault(fault)
    r = _run(lambda job: plant(job, monkeypatch))
    assert not r["correct"], r["checks"]
    c = r["checks"]["state_gap"]
    assert c["value"] > c["limit"], c


def test_control_fails_the_limit():
    """At 64² images: at 32² the last stage scans one token, where the states
    hold too small a part of y for bf16's rounding of it to stay under
    ``state_gap``'s limit, set at the cell's 224²."""
    r = readings(CELL, 2**31 + 9, 1.0, "cpu", CONTROL)
    for name in ("logit_gap", "state_gap"):
        limit = cell_spec(CELL)["limits"]["limits"][name]
        assert r["program"][name] < limit < r["control"][name], (name, r)
    assert r["fault_state"]["state_gap"] > limit, r


def test_parent_without_the_keys_fails_at_once(monkeypatch):
    """A program whose configuration has no MODEL.NUM_CLASSES fails while
    the run reads its configuration, before any set-up."""
    from benchmark import harness

    def old_defaults():
        c = default()
        c.MODEL.pop("NUM_CLASSES")
        return c

    from vm_asr_tpu_torch.core import config

    default = config.default_config
    monkeypatch.setattr(config, "default_config", old_defaults)
    t = time.perf_counter()
    with pytest.raises(KeyError, match="NUM_CLASSES"):
        harness.run_cell(CELL, 1, 1.0, False, t, device="cpu", overrides=FP32)
    assert time.perf_counter() - t < 5
