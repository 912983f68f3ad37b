#!/usr/bin/env python3
"""Read the numbers that decide ``correct`` over many seeds, in one process:
the program's (its lower readings), the control's, and the faults'.

    python3 benchmark/controls.py --workload <cell> --seeds 1,2,3 [--seconds 3]

For each seed the cell's set-up runs at the cell's own size. A serve cell
then sends requests for ``--seconds`` (its own load, long enough to finish
its longest clips) and compares the sample a run compares; a training cell
has taken its first steps in set-up. Then, beside the program's readings:

- ``control``: the reference computed with fp8 products (e4m3 forward,
  e5m2 gradients, ``reference.precision``) put in the program's place, the
  step below the configuration's bfloat16 (for a serve cell, its waveform
  quantised as a wav is written stands for the written file);
- ``fault_half`` (training): the reference on half of each batch, the mean
  taken over the rest;
- ``fault_still`` (training): a step that leaves the state as it was, which
  reads 1 by the leaf gaps' measure whatever the seed, so it is stated, not
  run;
- ``witness_bf16`` (training): the reference with bfloat16 products, the
  program's precision, independent of the program: where it reads as the
  program does, seed by seed, the reading is bf16's rounding;
- ``fault_scan_bwd`` (training): the reference with a scan whose backward
  returns no gradient for B and C, a fault of the scan's backward alone.

One JSON line a seed on standard output. ``--device cpu`` and
``--overrides`` (a JSON object, as ``harness.run_cell`` takes it) run it at
a size a CPU holds, for the tests.
"""

import sys
import time
from pathlib import Path

T_START = time.perf_counter()
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
        out = {"cell": cell, "seed": seed}
        if spec["mix"]["kind"] == "serve_clips":
            job.window(seconds)
            job.release()
            returned, written = job.program_readings()
            ref = job.reference_readings(Products("fp32"))
            ctrl = job.reference_readings(Products("fp8"))
            out["program"] = job.readings_against(ref, returned, written)
            out["control"] = job.readings_against(
                ref, ctrl, {i: kind.quantised(w).cpu() for i, w in ctrl.items()})
        else:
            job.release()
            prog = job.program_readings()
            ref = job.reference_readings(Products("fp32"))
            ctrl = job.reference_readings(Products("fp8"))
            half = job.reference_readings(Products("fp32"), rows=slice(0, job.batch // 2))
            witness = job.reference_readings(Products("bf16"))
            no_bc = _without_scan_bc_gradient(job)
            scan = job.scan_leaves(ref)
            for name, side in (("program", prog), ("control", ctrl), ("fault_half", half),
                               ("witness_bf16", witness), ("fault_scan_bwd", no_bc)):
                out[name] = job.readings_against(ref, side)
                # The look behind the medians: the worst leaves with their
                # reference norms, and the scan-fed leaves' gaps.
                grads, changes = job.leaf_gaps(ref, side)
                out[name]["worst"] = {
                    what: sorted(([k, round(v, 4), ref[key][k]] for g in gaps.values()
                                  for k, v in g.items()), key=lambda x: -x[1])[:4]
                    for what, gaps, key in (("grad", grads, "first_grads"),
                                            ("change", changes, "changes"))}
                own = job.scan_gaps(ref, side)
                out[name]["scan"] = {k: [round(own[k], 5), round(grads["generator."][k], 5),
                                         round(changes["generator."].get(k, -1.0), 5),
                                         ref["first_grads"][k], ref["changes"][k]]
                                     for k in scan}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _without_scan_bc_gradient(job) -> dict:
    """The reference's readings with a scan whose backward returns no dB
    or dC, a fault confined to the scan's backward (B and C detached)."""
    from benchmark.reference import generator
    from benchmark.reference.precision import Products

    scan = generator.selective_scan

    def faulty(u, dts, A, Bs, Cs, *args, **kwargs):
        return scan(u, dts, A, Bs.detach(), Cs.detach(), *args, **kwargs)

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
