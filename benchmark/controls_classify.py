#!/usr/bin/env python3
"""Read the numbers that decide ``correct`` in a classification cell over
many seeds, in one process: the program's, the control's, a witness's and
a fault's (``controls.py`` reads the serve and train cells).

    python3 benchmark/controls_classify.py --workload <cell> --seeds 1,2,3 [--seconds 3]

For each seed the cell's set-up runs at the cell's own size, the client
sends requests for ``--seconds``, and the sampled requests' rows are read
beside:

- ``control``: the reference computed with fp8 products (e4m3, one scale a
  tensor, ``reference.precision``) put in the program's place, the step
  below the configuration's bfloat16; for ``state_gap``, the reference
  scan on the route's inputs rounded so;
- ``witness_bf16``: the same with bfloat16, the program's precision,
  independent of the program (the route's inputs are bfloat16 already, so
  its ``state_gap`` reads the reference scan against itself);
- ``fault_state``: the reference with a scan that drops its last state
  channel (C_N = 0), a fault of the d_state-16 recurrence alone.

One JSON line a seed on standard output. ``--device cpu`` and
``--overrides`` (a JSON object, as ``harness.run_cell`` takes it) run it at
a size a CPU holds, for the tests.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
from typing import Optional  # noqa: E402


def readings(cell: str, seed: int, seconds: float, device: str = "cuda",
             overrides: Optional[dict] = None) -> dict:
    import importlib

    import torch

    from benchmark.harness import Run, cell_spec
    from benchmark.reference.precision import Products

    spec = cell_spec(cell)
    kind = importlib.import_module(f"benchmark.kinds.{spec['mix']['kind']}")
    tmp = Path(tempfile.mkdtemp(prefix="vmasr_controls_"))
    try:
        run = Run(spec, seed, torch.device(device), tmp, overrides=overrides)
        job = kind.Job(run)
        job.setup()
        job.window(seconds)
        job.release()
        ref = job.reference_readings(Products("fp32"))
        sides = {"program": job.program_readings(),
                 "control": job.reference_readings(Products("fp8")),
                 "witness_bf16": job.reference_readings(Products("bf16")),
                 "fault_state": _without_last_state(job)}
        states = job.state_gaps(("program", "fp8", "bf16", "fault_state"))
        route = {"program": "program", "control": "fp8", "witness_bf16": "bf16",
                 "fault_state": "fault_state"}
        out = {"cell": cell, "seed": seed, "requests": len(job.done)}
        for name, side in sides.items():
            out[name] = {**job.readings_against(ref, side), "state_gap": states[route[name]]}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _without_last_state(job) -> dict:
    """The reference's readings with a scan whose last state channel adds
    nothing to y (its C column zeroed)."""
    from benchmark.reference import generator
    from benchmark.reference.precision import Products

    scan = generator.selective_scan

    def faulty(u, dts, A, Bs, Cs, *args, **kwargs):
        cs = Cs.clone()
        cs[..., -1] = 0
        return scan(u, dts, A, Bs, cs, *args, **kwargs)

    generator.selective_scan = faulty
    try:
        return job.reference_readings(Products("fp32"))
    finally:
        generator.selective_scan = scan


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--overrides", default="{}")
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(args.workload, int(s), args.seconds, args.device, json.loads(args.overrides))
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
