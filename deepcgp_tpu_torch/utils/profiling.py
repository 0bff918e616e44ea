"""Tracing and throughput logging (counterpart of
``deepcgp_tpu/utils/profiling.py``):

* ``trace(log_dir)`` -- ``torch.profiler`` around everything inside (host
  activity, and the card's kernels and copies when CUDA is available),
  written into ``log_dir`` as a Chrome trace (chrome://tracing,
  Perfetto);
* ``annotate(name)`` -- a named region inside a trace;
* ``StepTimer`` / ``StepsPerSecLogger`` -- wall-clock optimizer steps/s
  between log entries, the ``steps_per_sec`` column of ``log.csv``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body; on exit write ``log_dir/trace_<time>.json``.
    Yields the profiler, whose ``key_averages()`` summarise the run."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f'trace_{time.time_ns()}.json'))


def annotate(name: str):
    """A named trace region (context manager)."""
    return torch.profiler.record_function(name)


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
