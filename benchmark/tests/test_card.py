"""One short run of each cell on the card, through ``run.py`` as the check
runs it: skipped without a card. On the card:
``python -m pytest benchmark/tests/test_card.py -q``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "7",
                        "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
