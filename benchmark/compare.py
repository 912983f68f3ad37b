"""The numbers that decide ``correct``, each a gap between the program and
the reference, and their limits (``limits/<cell>.json``).

- ``rel_gap(a, b)``: ‖a − b‖ / ‖b‖ over a whole waveform.
- ``leaf_gaps(p, r)``: for each leaf, the gap between the program's norm and
  the reference's, |‖p‖ − ‖r‖|, over the larger of the reference's norm of
  that leaf and of the median leaf, since some leaves are all but zero.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1).to(a.device)
    if a.shape != b.shape:
        return float("inf")
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp_min(1e-30))


def median(values: Iterable[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Per leaf |prog − ref| / max(ref, the median leaf's ref), over the
    leaves in ``keep`` (default all)."""
    keys = list(ref) if keep is None else list(keep)
    floor = median(ref[k] for k in ref)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor, 1e-30) for k in keys}


def checked(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for every limit of the cell."""
    missing = set(limits) - set(values)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}
