"""Throughput logging (counterpart of the ``StepTimer`` and
``StepsPerSecLogger`` of ``deepcgp_tpu/utils/profiling.py``): wall-clock
optimizer steps/s between log entries, the ``steps_per_sec`` column of
``log.csv``.  The device trace and named regions are not ported yet
(ROADMAP queue A)."""

from __future__ import annotations

import time


class StepTimer:
    """Tracks wall-clock optimizer throughput across train chunks."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._last_time = None
        self._last_step = None
        self.steps_per_sec = float('nan')

    def update(self, global_step: int) -> float:
        now = time.time()
        if self._last_time is not None and global_step > self._last_step:
            self.steps_per_sec = ((global_step - self._last_step)
                                  / (now - self._last_time))
        self._last_time = now
        self._last_step = global_step
        return self.steps_per_sec


class StepsPerSecLogger:
    """CSV column: optimizer steps/sec since the previous log entry."""

    title = 'steps_per_sec'

    def __init__(self):
        self.timer = StepTimer()

    def __call__(self, experiment) -> float:
        return round(self.timer.update(experiment.global_step), 3)
