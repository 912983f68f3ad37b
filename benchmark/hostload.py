"""What the host did while a run's window was open, for reading the spread
of host-clock metrics: the process's CPU time and involuntary context
switches, Python's garbage collections by generation, the whole machine's
CPU shares (busy, steal) from /proc/stat, the cgroup's CPU throttling, the
load average, and the cores the process may run on. ``snapshot`` reads a
few files outside the window; ``between`` gives the differences. Printed
on standard error; no metric reads it.
"""

from __future__ import annotations

import gc
import os
import resource
import time
from typing import Dict, Optional


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def _cgroup_throttled_s() -> Optional[float]:
    text = _read("/sys/fs/cgroup/cpu.stat")  # cgroup v2: throttled_usec
    if text is not None:
        for line in text.splitlines():
            k, _, v = line.partition(" ")
            if k == "throttled_usec":
                return int(v) * 1e-6
    text = _read("/sys/fs/cgroup/cpu/cpu.stat")  # v1: throttled_time in ns
    if text is not None:
        for line in text.splitlines():
            k, _, v = line.partition(" ")
            if k == "throttled_time":
                return int(v) * 1e-9
    return None


def snapshot() -> Dict[str, object]:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    stat = (_read("/proc/stat") or "cpu 0").splitlines()[0].split()[1:]
    mhz = [float(line.split(":")[1]) for line in (_read("/proc/cpuinfo") or "").splitlines()
           if line.startswith("cpu MHz")]
    return {"t": time.perf_counter(), "cpu_s": ru.ru_utime + ru.ru_stime,
            "invol": ru.ru_nivcsw, "gc": [s["collections"] for s in gc.get_stats()],
            "stat": [int(v) for v in stat], "throttled_s": _cgroup_throttled_s(),
            "mhz": sum(mhz) / len(mhz) if mhz else None}


def between(a: Dict[str, object], b: Dict[str, object]) -> Dict[str, object]:
    wall = b["t"] - a["t"]
    d = [y - x for x, y in zip(a["stat"], b["stat"])]
    total = sum(d)
    # /proc/stat's cpu line: user nice system idle iowait irq softirq steal ...
    idle = d[3] + (d[4] if len(d) > 4 else 0)
    steal = d[7] if len(d) > 7 else 0
    load = (_read("/proc/loadavg") or "").split()[:3]
    thr = None if a["throttled_s"] is None or b["throttled_s"] is None \
        else b["throttled_s"] - a["throttled_s"]
    return {"wall_s": wall, "process_cpu_share": (b["cpu_s"] - a["cpu_s"]) / wall,
            "involuntary_switches": b["invol"] - a["invol"],
            "gc_collections": [y - x for x, y in zip(a["gc"], b["gc"])],
            "machine_busy_share": 1 - idle / total if total else None,
            "machine_steal_share": steal / total if total else None,
            "cgroup_throttled_s": thr, "loadavg": load, "cpu_mhz": b["mhz"],
            "cores": len(os.sched_getaffinity(0)), "threads": len(os.listdir("/proc/self/task"))}
