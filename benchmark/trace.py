"""Reading a profiled sub-window: device busy time as the union of the
kernels' and copies' intervals, device time by kernel name, and the idle
gaps labelled by the harness span the host had open when each began.

The functions take plain event lists, so that they can be checked on a
synthetic list; ``events_of`` makes those lists from a ``torch.profiler``
capture (device events without the annotations the profiler mirrors onto
the device; host spans are the harness's ``record_function`` ranges, whose
names start with ``SPAN_PREFIX``).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

SPAN_PREFIX = "bench/"

Interval = Tuple[str, float, float]  # (name, start µs, end µs)


def events_of(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device intervals, harness host spans) of a finished profiler, in µs,
    read from its raw events: building ``prof.events()``'s tree of every
    host op takes tens of seconds for a few training steps."""
    import torch

    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name, start, end = e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and end > start:
                device.append((name, start, end))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], start, end))
    return device, spans


def sync(device) -> None:
    """Wait for the card, when the run is on one."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def merged(intervals: Iterable[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals as sorted, disjoint (start, end) pairs."""
    out: List[List[float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in merged(intervals))


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, arguments and template
    arguments, the group it is counted in."""
    name = re.sub(r"^void ", "", kernel).replace("(anonymous namespace)", "anon")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    return ("".join(out).strip() or kernel)[:120]


def time_by_name(intervals: Iterable[Interval], group: bool = True) -> Dict[str, float]:
    """Device µs by kernel name (or by ``short_name`` group)."""
    out: Dict[str, float] = defaultdict(float)
    for name, s, e in intervals:
        out[short_name(name) if group else name] += e - s
    return dict(out)


def matching_us(intervals: Iterable[Interval], patterns: Iterable[str]) -> float:
    """Device µs of the kernels whose name holds any of ``patterns``."""
    pats = tuple(patterns)
    return sum(e - s for name, s, e in intervals if any(p in name for p in pats))


def open_span(spans: List[Interval], t: float) -> str:
    """The innermost span open at ``t`` (the latest to start, the first to
    end among those); "none" if none is."""
    open_ = [(s, -e, name) for name, s, e in spans if s <= t < e]
    return max(open_)[2] if open_ else "none"


def idle_by_span(intervals: Iterable[Interval], spans: List[Interval], start: float,
                 end: float) -> Dict[str, float]:
    """The device's idle µs within [start, end], each gap given to the span
    open on the host when it began."""
    out: Dict[str, float] = defaultdict(float)
    t = start
    for s, e in merged(intervals):
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if s > t:
            out[open_span(spans, t)] += s - t
        t = max(t, e)
    if end > t:
        out[open_span(spans, t)] += end - t
    return dict(out)


def top(d: Dict[str, float], n: int = 10, scale: float = 1e-6) -> List[list]:
    """The ``n`` largest entries as [name, value × scale] (µs → s)."""
    return [[k, v * scale] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def profiled(spans, device, body) -> dict:
    """Run ``body`` under ``torch.profiler`` inside the harness span
    "window", and read the capture: the device intervals, their busy time,
    the window's length, and the breakdown (device time by kernel group,
    idle time by the host span open when each gap began)."""
    import torch

    sync(device)
    spans.profiling = True
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with spans.span("window"):
                body()
                sync(device)
    finally:
        spans.profiling = False
    dev, host = events_of(prof)
    w = [s for s in host if s[0] == "window"][0]
    busy = busy_us(dev)
    return {"device": dev, "busy_us": busy, "busy_s": busy * 1e-6,
            "window_s": (w[2] - w[1]) * 1e-6,
            "breakdown": {"device_ops": top(time_by_name(dev)),
                          "idle_gaps": top(idle_by_span(dev, host, w[1], w[2]))}}
