"""Tracing and throughput logging (counterpart of
``deepcgp_tpu/utils/profiling.py``):

* ``trace(log_dir)`` -- ``torch.profiler`` around everything inside (host
  activity, and the card's kernels and copies when CUDA is available),
  written into ``log_dir`` as a Chrome trace (chrome://tracing,
  Perfetto);
* ``annotate(name)`` -- a named region inside a trace;
* ``launch(name, reads, writes)`` -- the region of one hand-kernel launch
  (the kernels are loaded by ``ctypes``, so without it no operator owns
  their launches in a trace), which also tells the observers of
  :func:`observe_launches` the bytes the launch reads and writes;
* ``KERNEL_NAMES``, ``kernel_counters`` and ``profile_counted`` /
  ``profile_device`` -- the hand kernels by launch counter and by device
  name, and a profiled run whose recorded launches are held against the
  counters (the profiler can lose a round's device events);
* ``StepTimer`` / ``StepsPerSecLogger`` -- wall-clock optimizer steps/s
  between log entries, the ``steps_per_sec`` column of ``log.csv``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# The device kernels each launch counter counts, by name in the profiler.
KERNEL_NAMES = {'chol_inv_base': ('chol_factor_cluster_kernel',),
                'chol_inv_base_upper': ('chol_upper_cluster_kernel',),
                'tri_inv_base': ('tri_inv_strip_kernel',),
                'conv_rbf_cross': ('conv_rbf_cross_kernel',),
                'conv_rbf_cross_bwd': ('bwd_image_kernel', 'bwd_z_kernel'),
                'extract_patches_transposed': ('extract_transposed_kernel',),
                'col2im_transposed': ('col2im_transposed_kernel',)}
# Profiled rounds before a run whose device events stay short fails.
PROFILE_ROUNDS = 4

# The callbacks of observe_launches blocks, innermost last.
_OBSERVERS: list = []


@contextlib.contextmanager
def trace(log_dir: str, **options):
    """Profile the body; on exit write ``log_dir/trace_<time>.json``, whose
    path the profiler then holds as ``trace_path``.  Yields the profiler,
    whose ``key_averages()`` summarise the run; ``options`` go to
    ``torch.profiler.profile`` (``record_shapes``, ``with_stack``)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, **options) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(log_dir, f'trace_{time.time_ns()}.json')
    prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    """A named trace region (context manager)."""
    return torch.profiler.record_function(name)


def _nbytes(items) -> int:
    """Bytes of tensors (None counts 0) and of byte counts given as ints."""
    return sum(t if isinstance(t, int) else t.numel() * t.element_size()
               for t in items if t is not None)


@contextlib.contextmanager
def launch(name: str, reads=(), writes=()):
    """The region of one hand-kernel launch, named by its C entry point:
    a trace region, and (name, bytes of ``reads``, bytes of ``writes``,
    the shapes of their tensors) to every active :func:`observe_launches`
    block, unless a CUDA graph is being captured (a capture launches
    nothing).  ``reads`` and ``writes`` hold the tensors the kernel reads
    or writes whole, and the byte counts of what it reads of the
    others."""
    if _OBSERVERS and not (torch.cuda.is_available()
                           and torch.cuda.is_current_stream_capturing()):
        shapes = [tuple(t.shape) for t in (*reads, *writes)
                  if isinstance(t, torch.Tensor)]
        for record in _OBSERVERS:
            record.append((name, _nbytes(reads), _nbytes(writes), shapes))
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def observe_launches():
    """Yields a list that each hand-kernel launch inside the block appends
    (C entry point, bytes read, bytes written, shapes of the tensors read
    and written) to, in launch order."""
    record: list = []
    _OBSERVERS.append(record)
    try:
        yield record
    finally:
        _OBSERVERS.remove(record)


def kernel_counters() -> dict:
    """Every hand-kernel wrapper, by its KERNEL_NAMES name; each counts its
    launches in ``.launches``."""
    from deepcgp_tpu_torch.ops import cuda_cross, cuda_linalg, cuda_patches
    return {'chol_inv_base': cuda_linalg.chol_inv_base,
            'chol_inv_base_upper': cuda_linalg.chol_inv_base_upper,
            'tri_inv_base': cuda_linalg.tri_inv_base,
            'conv_rbf_cross': cuda_cross.conv_rbf_cross,
            'conv_rbf_cross_bwd': cuda_cross.conv_rbf_cross_bwd,
            'extract_patches_transposed':
                cuda_patches.extract_patches_transposed,
            'col2im_transposed': cuda_patches.col2im_transposed}


def reset_launches() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def device_entries(prof) -> list:
    """The profiler's device entries (kernels, copies, sets) by name, as
    ``key_averages()`` gives them, without the device spans of annotated
    regions, which repeat the time of the kernels inside them."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]


def profile_counted(fn, reset_counts=reset_launches, read_counts=read_launches,
                    log_dir: str | None = None, rounds: int = PROFILE_ROUNDS,
                    **options):
    """fn() under the profiler (host and, with a card, device activity),
    in rounds until a round records exactly the hand-kernel launches the
    counters saw: the profiler may lose a round's device events, and a
    trace or a busy time would then read low.  A round that recorded more
    launches than were made (another kernel matched) fails, as does
    ``rounds`` short rounds.  With ``log_dir`` each round goes through
    :func:`trace` (the last round's Chrome trace at ``prof.trace_path``).
    Returns (profiler, wall ms, rounds taken, launches made)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    recorded = made = {}
    for taken in range(1, rounds + 1):
        reset_counts()
        if log_dir is not None:
            context = trace(log_dir, **options)
        else:
            context = profile(activities=[ProfilerActivity.CPU]
                              + ([ProfilerActivity.CUDA] if cuda else []),
                              **options)
        with context as prof:
            t = time.perf_counter()
            fn()
            if cuda:
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        made = read_counts()
        device = device_entries(prof)
        recorded = {name: sum(e.count for e in device
                              if any(k in e.key for k in KERNEL_NAMES[name]))
                    for name in made}
        if any(recorded[n] > made[n] for n in made):
            raise RuntimeError(f'the profiler recorded {recorded} for '
                               f'launches {made}')
        if recorded == made:
            return prof, wall_ms, taken, made
    raise RuntimeError(f'in {rounds} profiled rounds the profiler recorded '
                       f'{recorded} of launches {made}')


def profile_device(fn, reset_counts=reset_launches,
                   read_counts=read_launches):
    """fn() under the profiler: (wall ms, device busy ms, the 12 device
    entries with the most time as [name, count, ms], rounds), from a round
    whose recorded launches match the counters (:func:`profile_counted`)."""
    prof, wall_ms, rounds, _ = profile_counted(fn, reset_counts, read_counts)
    events = [e for e in device_entries(prof) if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    return wall_ms, busy_ms, [[e.key[:90], e.count,
                               e.self_device_time_total / 1e3]
                              for e in top], rounds


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
