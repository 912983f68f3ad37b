"""Reading the program's own spans: the phases that the port records
(``vm_asr_tpu_torch.core.profiling.span``) while a profiler collects, which
the profiled sub-window of a traced run holds. Their times are
``time.time_ns()``, the clock of the profiler's events, so they line up with
``ctx["device"]`` (µs, as ``trace.events_of`` reads it).

The rule: each idle µs of the device inside an outermost program span (a
request or a step) goes to the innermost program span open at that µs, so a
gap that crosses spans is split between them. (The breakdown's
``trace.idle_by_span`` gives a whole gap to the harness span open where it
began.)

A program that records no spans (one without the recorder) gives None, and
each reader then reports nothing.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from .trace import merged

Interval = Tuple[str, float, float]  # (name, start µs, end µs)


def recorded() -> Optional[list]:
    """The program's recorded spans, or None where it records none."""
    try:
        from vm_asr_tpu_torch.core.profiling import recorded_spans
    except ImportError:
        return None
    return recorded_spans() or None


def outermost(spans, name: str) -> list:
    """The outermost spans called ``name``: the requests or the steps."""
    return [s for s in spans if s.parent == 0 and s.name == name]


def host_us(spans, name: str) -> float:
    """µs the host spent in the spans called ``name``."""
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e3


def innermost(spans: Iterable[Interval]) -> List[Interval]:
    """The time inside the outermost spans cut into pieces, each named by the
    innermost span open over it (the latest to start; of those, the first to
    end). ``spans`` and the pieces: (name, start µs, end µs)."""
    spans = list(spans)
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        open_ = [(s, -e, name) for name, s, e in spans if s <= a and e >= b]
        if open_:
            pieces.append((max(open_)[2], a, b))
    return pieces


def idle_us(device: Iterable[Interval], pieces: List[Interval]) -> Dict[str, float]:
    """The device's idle µs within each piece, summed by the piece's name."""
    busy = merged(device)
    out: Dict[str, float] = {}
    j = 0
    for name, a, b in sorted(pieces, key=lambda p: p[1]):
        covered = 0.0
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
        out[name] = out.get(name, 0.0) + (b - a) - covered
    return out


def idle_by_span(device: Iterable[Interval], spans) -> Dict[str, float]:
    """The device's idle µs by the innermost program span open, over the
    time inside the outermost spans."""
    return idle_us(device, innermost((s.name, s.start_ns / 1e3, s.end_ns / 1e3)
                                     for s in spans))


def per_unit_ms(ctx, names: Iterable[str], unit: str) -> Optional[float]:
    """Idle ms under the spans ``names`` for each outermost ``unit`` span
    (a request or a step) of the profiled sub-window, or None without
    program spans."""
    spans = recorded()
    if spans is None:
        return None
    units = outermost(spans, unit)
    if not units:
        return None
    idle = idle_by_span(ctx["device"], spans)
    return sum(idle.get(n, 0.0) for n in names) / len(units) / 1e3
