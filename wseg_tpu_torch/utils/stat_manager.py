"""Named running averages for losses (reference utils/stat_manager.py)."""

from __future__ import annotations

from typing import Dict


class StatManager:
    def __init__(self):
        self.vals: Dict[str, float] = {}
        self.counts: Dict[str, float] = {}

    def add_val(self, key: str):
        self.vals.setdefault(key, 0.0)
        self.counts.setdefault(key, 0.0)

    def update_stats(self, key: str, value: float, count: float = 1.0):
        self.vals[key] = self.vals.get(key, 0.0) + float(value) * count
        self.counts[key] = self.counts.get(key, 0.0) + count

    def has_vals(self, key: str) -> bool:
        return self.counts.get(key, 0.0) > 0

    def summarize_key(self, key: str) -> float:
        if self.counts.get(key, 0.0) == 0:
            return 0.0
        return self.vals[key] / self.counts[key]
