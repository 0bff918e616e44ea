"""Tracing and throughput logging (counterpart of
``deepcgp_tpu/utils/profiling.py``):

* ``trace(log_dir)`` -- ``torch.profiler`` around everything inside (host
  activity, and the card's kernels and copies when CUDA is available),
  written into ``log_dir`` as a Chrome trace (chrome://tracing,
  Perfetto);
* ``annotate(name, request=, device=)`` -- a span of the program: a
  named region inside a trace, and a span of the active
  :func:`recording` (host times, and with ``device`` the device's work
  between its CUDA events on the same clock); off, a shared null
  context;
* ``recording()`` -- the recorder of spans without the profiler, and
  ``summary`` of what it recorded: wall and device-busy time, each
  span's count, total and self ms, the device's idle time by span;
* ``COUNTERS`` -- process-wide counts of the program's events
  (``'graph captures'``, ``'fused adam steps'``, ``'natgrad updates'``,
  ``'natgrad route <route>'``, ``'cross route fused'`` / ``'unfused'``);
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

import bisect
import collections
import contextlib
import dataclasses
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


# Process-wide counts of the program's events, always on; a caller reads
# one before and after a stretch.  'graph captures': the CUDA graphs
# ``training.graphs.GraphCache`` captured (a key that changed on every
# call would recapture in a timed window); 'fused adam steps': the
# ``trainer.train_step`` calls that took the Adam kernels; 'natgrad
# updates': the ``train_step`` calls that took the natural-gradient step;
# 'natgrad route upper' / 'panels' / 'library': the ``optim.
# natgrad_update`` calls by the route of their solve
# (``optim.natgrad_route``); 'cross route fused' / 'unfused': the patch
# kernels' ``Kzx_NM_and_Kdiag`` calls by route (``cuda_cross.fused_fits``).
# A counter counts Python calls, eager steps and captures: it does not run
# inside a replay, which repeats its capture's step without a call.
COUNTERS: collections.Counter = collections.Counter()

# What annotate returns while nothing traces or records.
_OFF = contextlib.nullcontext()
# The active recording (one at a time), or None.
_RECORDER = None
# The device's idle time over no span of the program, in a summary.
OUTSIDE_SPANS = 'outside spans'


def annotate(name: str, *, request=None, device: bool = False):
    """A span of the program (context manager): the trace region ``name``
    while ``torch.profiler`` runs, on the device trace's own clock, and a
    :class:`Span` of the active :func:`recording` carrying ``request``
    (the chunk, step or request it belongs to) and, with ``device`` on a
    CUDA device, a pair of CUDA events around the device work the span
    enqueues on the current stream (none while the stream captures a
    graph).  With neither on it is one shared null context."""
    if _RECORDER is None and not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return _SpanContext(name, request, device)


class _SpanContext:
    __slots__ = ('name', 'request', 'device', '_region', '_recorder',
                 '_span')

    def __init__(self, name, request, device):
        self.name, self.request, self.device = name, request, device
        self._region = self._recorder = self._span = None

    def __enter__(self):
        if torch.autograd.profiler._is_profiler_enabled:
            self._region = torch.profiler.record_function(self.name)
            self._region.__enter__()
        if _RECORDER is not None:
            self._recorder = _RECORDER
            self._span = _RECORDER.open(self.name, self.request, self.device)
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            self._recorder.close(self._span)
        if self._region is not None:
            self._region.__exit__(*exc)
        return False


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span: its name, its id and its parent's (the
    innermost span open at its start, None for none), the request it
    carries, its host start and end (``time.perf_counter_ns``) and, for a
    span with device work, the interval between its CUDA events on the
    same clock (``device_ns``, set when the recording closes)."""
    name: str
    id: int
    parent: int | None
    request: object
    start_ns: int
    end_ns: int | None = None
    device_ns: tuple | None = None


class Recording:
    """The spans of one :func:`recording` block, in the order they
    opened, and the block's host start and end (``start_ns``,
    ``end_ns``).  Spans stay in memory; nothing is written."""

    def __init__(self, device, events: int):
        self.device = device
        self.spans: list = []
        self.start_ns = self.end_ns = None
        self._open: list = []
        self._begun: dict = {}       # span id -> (entry's event, stream)
        self._pairs: list = []
        self._pool = [self._new_event() for _ in range(events)] \
            if device is not None else []
        self._anchor = None

    @staticmethod
    def _new_event():
        return torch.cuda.Event(enable_timing=True)

    def _event(self):
        return self._pool.pop() if self._pool else self._new_event()

    def _start(self) -> None:
        if self.device is not None:
            torch.cuda.synchronize(self.device)
            self._anchor = self._event()
            self._anchor.record(torch.cuda.current_stream(self.device))
        self.start_ns = time.perf_counter_ns()

    def _stop(self) -> None:
        """Wait for the device, then place each span's pair of events on
        the host clock: the anchor's host time plus the device time from
        the anchor to the event."""
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        self.end_ns = time.perf_counter_ns()
        for span, begin, end in self._pairs:
            span.device_ns = tuple(
                self.start_ns + round(self._anchor.elapsed_time(e) * 1e6)
                for e in (begin, end))
        self._pairs = []

    def open(self, name: str, request, device: bool) -> Span:
        span = Span(name, len(self.spans),
                    self._open[-1].id if self._open else None, request,
                    time.perf_counter_ns())
        self.spans.append(span)
        self._open.append(span)
        if (device and self.device is not None
                and not torch.cuda.is_current_stream_capturing()):
            stream = torch.cuda.current_stream(self.device)
            begin = self._event()
            begin.record(stream)
            self._begun[span.id] = begin, stream
        return span

    def close(self, span: Span) -> None:
        """End ``span``; a device span's second event goes on the stream
        its first did."""
        begun = self._begun.pop(span.id, None)
        if begun is not None:
            end = self._event()
            end.record(begun[1])
            self._pairs.append((span, begun[0], end))
        span.end_ns = time.perf_counter_ns()
        self._open.remove(span)

    def summary(self) -> dict:
        """:func:`summary` of the closed recording."""
        if self.end_ns is None:
            raise RuntimeError('the recording is still open')
        return summary(self.spans, self.start_ns, self.end_ns)


@contextlib.contextmanager
def recording(events: int = 1024):
    """Record the program's spans (:func:`annotate`) inside the block,
    without the profiler; yields the :class:`Recording`.  With CUDA, on
    entry it waits for the current device and records an anchor event at
    the host time the window starts; on exit it waits again and places
    every span's device interval on the host clock, within the few
    microseconds the anchor runs after its host time (without CUDA it
    records host times only).  ``events`` CUDA events are made up front,
    more when they run out.  One recording at a time."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError('a recording is already on')
    rec = Recording(torch.device('cuda', torch.cuda.current_device())
                    if torch.cuda.is_available() else None, events)
    rec._start()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = None
        rec._stop()


def _union(intervals) -> list:
    """The merged [start, end] intervals of (start, end) pairs."""
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        elif b > a:
            merged.append([a, b])
    return merged


def summary(spans, start_ns: int, end_ns: int) -> dict:
    """What the spans of a window [``start_ns``, ``end_ns``] add up to:
    ``wall_ns``; ``busy_ns``, the union of the spans' device intervals
    clipped to the window; ``spans``, each name's ``count``, total ``ms``
    and ``self_ms`` (each span's duration less the part its children
    cover); ``idle_ms``, the device's idle gaps in the window summed by
    the innermost span over each gap's middle (``OUTSIDE_SPANS`` where no
    span is open).  Spans nest: each lies inside its parent."""
    busy = _union((max(a, start_ns), min(b, end_ns))
                  for a, b in (s.device_ns for s in spans
                               if s.device_ns is not None))
    children = collections.defaultdict(list)
    for s in spans:
        children[s.parent].append(s)
    by_name: dict = {}
    for s in spans:
        covered = sum(b - a for a, b in _union(
            (c.start_ns, c.end_ns) for c in children.get(s.id, ())))
        entry = by_name.setdefault(s.name,
                                   {'count': 0, 'ms': 0.0, 'self_ms': 0.0})
        entry['count'] += 1
        entry['ms'] += (s.end_ns - s.start_ns) / 1e6
        entry['self_ms'] += (s.end_ns - s.start_ns - covered) / 1e6
    starts = {k: [c.start_ns for c in v] for k, v in children.items()}

    def innermost(t):
        level, found = None, None
        while level in children:
            i = bisect.bisect_right(starts[level], t) - 1
            if i < 0 or children[level][i].end_ns < t:
                break
            found = children[level][i]
            level = found.id
        return OUTSIDE_SPANS if found is None else found.name

    idle: collections.Counter = collections.Counter()
    prev = start_ns
    for a, b in busy + [[end_ns, end_ns]]:
        if a > prev:
            idle[innermost((prev + a) / 2)] += (a - prev) / 1e6
        prev = max(prev, b)
    return {'wall_ns': end_ns - start_ns,
            'busy_ns': sum(b - a for a, b in busy),
            'spans': by_name, 'idle_ms': dict(idle)}


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
