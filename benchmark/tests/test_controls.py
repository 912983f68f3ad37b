"""The control and the faults at a size a CPU holds: the reference with fp8
products, put in the program's place, and the reference on half of each
batch both read above the cell's limits, while the program itself (bf16
here, as the configurations state) reads below the control. On the card
``controls.py`` reads the same at each cell's own size over many seeds."""

import pytest

from benchmark.controls import readings
from benchmark.harness import cell_spec

T_SEG = 63 * 240 / 48000
TINY = {"program": {"MODEL": {"VSSM": {"DIMS": 8, "DEPTHS": [1, 1, 1, 1]}},
                    "DATA": {"SEGMENT": T_SEG, "STFT": {"N_FFT": 512, "WIN_LENGTH": 512}},
                    "TRAIN": {"ADVERSARIAL": {"MPD_HIDDEN": 2, "MPD_PERIODS": [2, 3]}}},
        "mix": {"pool": 4, "length": {"dist": "uniform", "min_s": 0.3, "max_s": 1.0},
                "sample": 3, "batch": 2, "warmup_steps": 0}}


@pytest.mark.parametrize("cell", ["vmasr48k_d16.serve_vctk", "vmasr48k_d16.train_b4"])
def test_control_fails_a_limit(cell):
    r = readings(cell, 2**31 + 9, 1.0, "cpu", TINY)
    limits = cell_spec(cell)["limits"]["limits"]
    assert any(r["control"][k] > v for k, v in limits.items()), (r, limits)
    if "fault_half" in r:
        assert any(r["fault_half"][k] > v for k, v in limits.items()), (r, limits)
    assert max(r["control"][k] for k in limits) > max(r["program"][k] for k in limits)
