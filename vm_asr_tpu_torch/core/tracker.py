"""Running metric aggregation (port of vm_asr_tpu/core/tracker.py; reference
utils/utils.py:39-79 MetricTracker, there backed by a pandas DataFrame)."""

from __future__ import annotations

from typing import Dict


class MetricTracker:
    """The running mean of each metric key, in the order first seen."""

    def __init__(self):
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def update(self, key: str, value: float) -> None:
        self._totals[key] = self._totals.get(key, 0.0) + float(value)
        self._counts[key] = self._counts.get(key, 0) + 1

    def result(self) -> Dict[str, float]:
        return {k: t / self._counts[k] for k, t in self._totals.items()}
