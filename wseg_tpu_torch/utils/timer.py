"""Wall-clock stage timing + ETA (reference utils/timer.py:3-26)."""

from __future__ import annotations

import datetime
import time


class Timer:
    def __init__(self, msg: str = ""):
        if msg:
            print(msg)
        self.start = time.time()
        self.stage_start = self.start
        self.progress = 0.0

    def reset_stage(self):
        self.stage_start = time.time()

    def get_stage_elapsed(self) -> float:
        return max(1e-6, time.time() - self.stage_start)

    def update_progress(self, p: float):
        self.progress = max(1e-6, p)

    def est_finish(self) -> float:
        elapsed = time.time() - self.start
        return self.start + elapsed / self.progress

    def str_est_finish(self) -> str:
        return datetime.datetime.fromtimestamp(
            self.est_finish()).strftime("%H:%M:%S")
