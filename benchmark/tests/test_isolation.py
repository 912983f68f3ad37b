"""What the benchmark loads: nothing of JAX or of the JAX package, compared
by whole top-level module names (``vm_asr_tpu_torch`` is the port, and is
allowed), and its reference nothing of the program either."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_ALL = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import benchmark
names = [m.name for m in pkgutil.walk_packages(benchmark.__path__, "benchmark.")
         if ".tests" not in m.name]
for name in names:
    importlib.import_module(name)
from benchmark.harness import BENCH, metric_reader
for f in sorted((BENCH / "metrics").glob("*.py")):
    metric_reader(f.stem)
import benchmark.run, benchmark.controls
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden})
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""

_REFERENCE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import benchmark.reference as r
for m in pkgutil.walk_packages(r.__path__, "benchmark.reference."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden})
print(bad)
sys.exit(1 if bad else 0)
"""


def _run(code):
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr


def test_benchmark_loads_no_jax():
    _run(_ALL.format(root=str(ROOT), forbidden=("jax", "jaxlib", "flax", "vm_asr_tpu")))


def test_reference_loads_nothing_of_the_program():
    _run(_REFERENCE.format(root=str(ROOT), forbidden=("jax", "jaxlib", "flax", "vm_asr_tpu",
                                                       "vm_asr_tpu_torch")))
