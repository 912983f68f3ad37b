"""The harness: one run of one cell.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness finds each by name: ``configs/<config>.json`` (the program's
configuration, frozen, with the reference module that checks it),
``traffic/<mix>.json`` (the mix's parameters and the ``kind`` of traffic),
``kinds/<kind>.py`` (the generator and runner of that kind), ``limits/<cell>.json``
(the limits of the numbers that decide ``correct``) and
``metrics/<metric>.py`` (one reader a per-layer metric). Adding a cell or a
metric adds files and edits none.

A kind's ``Job`` has ``setup()``, ``window(seconds)``, ``traced()``
(a profiled sub-window after the measured one), ``release()`` (frees the
program's state) and ``check()`` (the reference's comparison). The harness
times set-up from the start of the process, reads the peak memory before
the reference runs, and prints the result.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import logging
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

from . import hostload

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vm_asr_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of BENCHMARK.json with its configuration, mix and
    limits, and the per-layer metrics that list it."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = load_json(BENCH / "configs" / f"{cell['config']}.json")
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{name}.json")

    def reports(metric):
        return name in metric.get("workloads", [name])

    return dict(cell=cell, config=cfg, mix=mix, limits=limits, run_seconds=bench["run_seconds"],
                end_to_end=[m for m in bench["end_to_end"] if reports(m)],
                per_layer=[m for m in bench["per_layer"] if reports(m)])


def program_config(cfg_file: dict, output_dir: str):
    """The program's configuration: its defaults, then every value of the
    frozen file, then the run's output directory and no logging extras."""
    from vm_asr_tpu_torch.core.config import default_config

    cfg = default_config()
    cfg.merge_from_dict(cfg_file["program"])
    cfg.OUTPUT = output_dir
    cfg.TENSORBOARD.ENABLE = False
    cfg.WANDB.ENABLE = False
    return cfg.freeze()


def quiet_logger() -> logging.Logger:
    log = logging.getLogger("benchmark.program")
    log.handlers[:] = [logging.NullHandler()]
    log.propagate = False
    return log


class Spans:
    """Host spans the harness records around its calls into the program:
    (name, start, end) on ``time.perf_counter``, and while a profiler runs
    also ``record_function`` ranges that the trace reader finds."""

    def __init__(self):
        self.records: List[tuple] = []
        self.enabled = False
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        rf = contextlib.nullcontext()
        if self.profiling:
            import torch

            from .trace import SPAN_PREFIX
            rf = torch.profiler.record_function(SPAN_PREFIX + name)
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                self.records.append((name, t0, time.perf_counter()))

    def wrap(self, obj, attr: str, name: str, after: Optional[Callable] = None) -> None:
        """Replace ``obj.attr`` (an instance's callable) by one inside a span;
        ``after`` runs inside the span once the call returns."""
        fn = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            with self.span(name):
                out = fn(*args, **kwargs)
                if after is not None:
                    after()
                return out

        setattr(obj, attr, wrapped)

    def total(self, name: str) -> float:
        return sum(e - s for n, s, e in self.records if n == name)

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.records if n == name)


class Run:
    """What a kind's Job is given: the cell, its configuration and mix, the
    seed, the device, the spans, a scratch directory under TMPDIR, and an
    optional ``fault`` (tests plant one) and ``overrides`` of the
    configuration ("program") and the mix ("mix"), which tests use to run a
    cell at a size a CPU holds."""

    def __init__(self, spec: dict, seed: int, device, tmp: Path, fault=None,
                 overrides: Optional[dict] = None):
        self.spec = spec
        self.cell = spec["cell"]
        self.cfg_file = spec["config"]
        over = overrides or {}
        self.mix = {**spec["mix"], **over.get("mix", {})}
        self.limits = spec["limits"]
        self.seed = int(seed)
        self.device = device
        self.tmp = tmp
        self.fault = fault
        self.spans = Spans()
        program = json.loads(json.dumps(self.cfg_file["program"]))
        _merge(program, over.get("program", {}))
        self.cfg_dict = program
        self.cfg = program_config({"program": program}, str(tmp / "output"))
        self.log = quiet_logger()
        self.marks = [("start", time.perf_counter())]
        self.peaks = None
        if self.device.type == "cuda":
            import torch

            name = torch.cuda.get_device_name(self.device)
            peaks = load_json(BENCH / "peaks.json")
            if name not in peaks:
                raise KeyError(f"no peaks listed for {name!r} in peaks.json")
            self.peaks = peaks[name]


    def mark(self, name: str) -> None:
        """The end of a phase of set-up (printed to standard error)."""
        self.marks.append((name, time.perf_counter()))


def _merge(d: dict, over: dict) -> None:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            _merge(d[k], v)
        else:
            d[k] = v


def metric_reader(name: str) -> Callable:
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", fault=None, overrides: Optional[dict] = None,
             root: Path = ROOT) -> dict:
    """One run of cell ``name``; returns the result line's object with the
    numbers compared last (``checks``)."""
    import torch

    spec = cell_spec(name, root)
    kind = importlib.import_module(f"benchmark.kinds.{spec['mix']['kind']}")
    tmp = Path(tempfile.mkdtemp(prefix="vmasr_bench_"))
    try:
        run = Run(spec, seed, torch.device(device), tmp, fault, overrides)
        job = kind.Job(run)
        job.setup()
        setup_s = time.perf_counter() - t_start
        print("set-up: imports %.2f s, " % (run.marks[0][1] - t_start) + ", ".join(
            f"{name} {t - t0:.2f} s" for (_, t0), (name, t) in zip(run.marks, run.marks[1:])),
            file=sys.stderr)
        run.spans.enabled = trace
        if trace:
            job.trace_hooks()
        before = hostload.snapshot()
        e2e = job.window(seconds)
        print("host in the window: " + json.dumps(hostload.between(before, hostload.snapshot())),
              file=sys.stderr)
        layer, breakdown, dev = {}, None, {}
        if trace:
            ctx = job.traced()
            for m in spec["per_layer"]:
                value = metric_reader(m["name"])(ctx)
                if value is not None:
                    layer[m["name"]] = {"value": value, "unit": m["unit"]}
            breakdown = ctx.get("breakdown")
            dev = {"busy_s": ctx["busy_s"], "window_s": ctx["window_s"]}
        if run.device.type == "cuda":
            peak = max(torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count()))
            kind_name = torch.cuda.get_device_name(run.device)
        else:
            peak, kind_name = 0, "cpu"
        job.release()
        checks = job.check()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    e2e["setup_s"] = setup_s
    metrics = layer if trace else {
        m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in spec["end_to_end"]}
    result = {
        "correct": bool(e2e["failed"] == 0
                        and all(c["value"] <= c["limit"] for c in checks.values())),
        "attempted": e2e["attempted"],
        "failed": e2e["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if run.device.type == "cuda" else "cpu", "kind": kind_name,
                   "count": 1, "memory_peak_bytes": int(peak), **dev},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
