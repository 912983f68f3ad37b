"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in ``vm_asr_tpu_torch/csrc/`` that exports a plain C function
becomes one shared library, compiled for Hopper (``sm_90a``) at first use and
cached under ``build/kernels/`` at the repository root, keyed by a hash of the
sources, the headers and the flags. ``build()`` compiles every missing
library with one ``nvcc`` per source, all started together, and keeps each
nvcc's log beside its library (``ptxas_info`` reads from it what ptxas made of
each kernel: registers, shared memory, spill stores and loads)::

    python -c "from vm_asr_tpu_torch.ops.build import build; print(build())"

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fused_scan.cu", "fused_scan_bwd.cu", "linear_recurrence.cu", "nstate_scan.cu",
           "layer_norm.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH; raises if absent."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "$PATH): the CUDA kernels cannot be built on this machine"
        )
    return found


def library_path(source: str) -> Path:
    """Where the library built from ``source`` lives, by content hash."""
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library in ``sources`` that is not built yet, all nvcc
    processes at once. Returns {source: seconds} for the ones compiled;
    raises with nvcc's output if any compile fails."""
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for src in todo:
        out = library_path(src)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failures = {}, []
    for src, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc {src} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def ptxas_info(source: str) -> list:
    """ptxas's lines for the built library of ``source``: per kernel, its
    registers and constant/shared memory ("ptxas info : Used ...") and its
    stack frame with spill stores and loads."""
    log = library_path(source).with_suffix(".log")
    return [line.strip() for line in log.read_text().splitlines()
            if "ptxas info" in line or "spill" in line]


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, built first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))
            _loaded[source] = lib
        return lib
