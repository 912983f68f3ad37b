#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. With ``--trace 0`` the result's metrics are
the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics,
read from host spans and a profiled sub-window after the measured one. The
last line of standard output is the result, one JSON object; the numbers
that decided ``correct`` are the last lines of standard error, each beside
its limit. Without a card (or with fewer than the cell asks for) the run
exits 2 and prints no result; if JAX or the JAX package was loaded, it
exits 3.

Caches of compiled code live at fixed paths inside the checkout: the port
keeps its kernels in build/kernels/ and its host library in build/native/,
and CUDA's, torch's and Triton's caches go to build/bench_cache/.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _var, _sub in (("CUDA_CACHE_PATH", "cuda"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(ROOT / "build" / "bench_cache" / _sub)
sys.path[0] = str(ROOT)  # the checkout, not benchmark/: the harness is the package "benchmark"

# Host threads of one run: a fixed, small number, for steady runs.
HOST_THREADS = 4


def power_limit_w():
    """The card's power limit as nvidia-smi reads it (a card set below its
    maximum runs slower under load), or None."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
        return float(r.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import cell_spec, forbidden_modules, run_cell

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 2
    chips = cell_spec(args.workload)["cell"]["chips"]
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} card(s); {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    torch.set_num_threads(HOST_THREADS)
    result = run_cell(args.workload, args.seed % 2**63, args.seconds, bool(args.trace),
                      T_START)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    result["device"]["power_limit_w"] = power_limit_w()
    print(f"card: {result['device']['kind']}, power limit {result['device']['power_limit_w']} W",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
