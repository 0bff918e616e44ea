"""Reading a ``torch.profiler`` Chrome trace: device time by the program's
source function, the device's busy time over a window, and the longest
device operations and idle gaps.

The trace parsing (:func:`parse_trace`, :func:`region_steps`,
:func:`join`, :func:`attribute`) and the bucket rules
(``SOURCE_BUCKETS``, ``LAUNCHES``) are frozen copies of
``deepcgp_tpu_torch/tools/roofline.py`` at commit 1992fdc, so that a
change to the program's tool cannot move the benchmark's numbers.  What
the benchmark takes from the program is its trace regions ('graph eager
step', 'graph replay step': ``training/graphs.py``), its hand kernels'
launch regions and device names, and its source files' names.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import re
import tempfile

# Device work in a Chrome trace.
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
# The program's regions of a training step: the step graph's eager run
# before its capture, and each replay.
EAGER_STEP = 'graph eager step'
REPLAY_STEP = 'graph replay step'
# The runtime call that launches a replay's graph.
GRAPH_LAUNCH = 'cudaGraphLaunch'
# The benchmark's own region around a traced stretch, and the steps or
# requests run under the same profiler before it.
WINDOW = 'portbench window'
WARM = 10
# The hand kernels' launch regions, by C entry point, and the device
# kernel each launches.
LAUNCHES = {'chol_factor_blocked': 'chol_factor_cluster_kernel',
            'chol_upper_blocked': 'chol_upper_cluster_kernel',
            'tri_inv_blocked': 'tri_inv_strip_kernel',
            'conv_rbf_cross': 'conv_rbf_cross_kernel',
            'conv_rbf_cross_bwd_image': 'bwd_image_kernel',
            'conv_rbf_cross_bwd_z': 'bwd_z_kernel',
            'extract_patches_transposed': 'extract_transposed_kernel',
            'col2im_transposed': 'col2im_transposed_kernel'}
# Bucket attribution by the program's frames that launched a kernel (outer
# to inner, 'module/file.py:function' joined by ' > '; a '$' anchors the
# innermost), first match wins.
SOURCE_BUCKETS = [
    ('conv-Kuf', r'(conv_kernels|base_kernels|distances|cuda_cross|'
                 r'cuda_patches|ops/patches|views|mean_functions)\.py'),
    ('chol/solve', r'linalg\.py:(chol|cholesky|tri_inv|upper|_bigchol)|'
                   r'cuda_linalg\.py'),
    ('kl', r'linalg\.py:(_?gauss_kl|syrk_sum)|layers\.py:KL|dgp\.py:prior_kl'),
    ('qsqrt-term', r'conditional\.py'),
    ('optimizer', r'optim\.py|trainer\.py:train_step$'),
    ('sampling/likelihood', r'likelihoods\.py|layers\.py:_sample|'
                            r'dgp\.py:propagate'),
    ('elbo', r'dgp\.py|trainer\.py:loss_and_grads$'),
    ('batch', r'trainer\.py:(batch|step|run_chunk)$'),
]
OUTSIDE = 'outside the steps'

_FRAME = re.compile(r'deepcgp_tpu_torch/(\S+\.py)\((\d+)\): (\S+)')


def profile(fn, with_stack: bool = False) -> 'Trace':
    """fn() under ``torch.profiler`` (host and device activity, with
    Python stacks if asked), its Chrome trace read and deleted."""
    import torch
    from torch.profiler import ProfilerActivity
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with torch.profiler.profile(activities=activities,
                                with_stack=with_stack) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, 'trace.json')
        prof.export_chrome_trace(path)
        return parse_trace(path)


def source_bucket_of(source: str) -> str:
    for bucket, pat in SOURCE_BUCKETS:
        if re.search(pat, source):
            return bucket
    return 'other'


@dataclasses.dataclass
class Trace:
    """The device events of a Chrome trace (dicts name, ts, dur, host_ts:
    the host time of the launch, op: the launching operator's External id,
    launch: the runtime call's name), the host operators (External id ->
    event with 'frames', the program's enclosing frames outer to inner,
    and 'seq', the autograd sequence number of the enclosing backward),
    the user regions (name -> sorted [(start, end)]), the forward frames
    of each sequence number, the hand kernels' launch regions and the
    host events (for what the host did in an idle gap)."""
    events: list
    ops: dict
    regions: dict
    forward: dict
    launches: dict
    host: list


def _sweep(host: list):
    """Annotate each operator of one thread (sorted by start, outer first)
    with its enclosing frames and backward function."""
    stack: list = []
    for e in host:
        end = e['ts'] + e.get('dur', 0)
        while stack and stack[-1][1] <= e['ts']:
            stack.pop()
        if e.get('cat') in ('cpu_op', 'user_annotation'):
            frames, seq = [], None
            for s, _ in stack:
                if s.get('cat') == 'python_function':
                    m = _FRAME.search(s['name'])
                    if m and not m.group(1).startswith(
                            ('tools/', 'utils/profiling.py')):
                        frames.append(f'{m.group(1)}:{m.group(3)}')
                elif s['name'].startswith('autograd::engine::evaluate_function'):
                    seq = s['args'].get('Sequence number')
            e['frames'], e['seq'] = frames, seq
        stack.append((e, end))


def parse_trace(path: str) -> Trace:
    """Read a Chrome trace exported by ``torch.profiler``."""
    with open(path) as f:
        events = [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X']
    host_cats = ('cpu_op', 'user_annotation', 'python_function')
    by_thread = collections.defaultdict(list)
    runtime = {}
    host = []
    for e in events:
        cat = e.get('cat')
        if cat in host_cats:
            by_thread[(e['pid'], e['tid'])].append(e)
        if cat in ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver'):
            host.append(e)
        if cat in ('cuda_runtime', 'cuda_driver'):
            corr = (e.get('args') or {}).get('correlation')
            if corr is not None:
                runtime[corr] = e
    for thread in by_thread.values():
        thread.sort(key=lambda e: (e['ts'], -e.get('dur', 0)))
        _sweep(thread)
    ops, regions, forward = {}, collections.defaultdict(list), {}
    for e in events:
        cat = e.get('cat')
        if cat not in ('cpu_op', 'user_annotation'):
            continue
        ext = e['args'].get('External id')
        if ext is not None:
            ops[ext] = e
        if cat == 'user_annotation':
            regions[e['name']].append((e['ts'], e['ts'] + e.get('dur', 0)))
        seq = e['args'].get('Sequence number')
        if (seq is not None and e['seq'] is None and e['frames']
                and not e['args'].get('Fwd thread id')):
            forward.setdefault(seq, e['frames'])
    for spans in regions.values():
        spans.sort()
    device = []
    for e in events:
        if e.get('cat') not in DEVICE_CATS:
            continue
        args = e.get('args') or {}
        ext = args.get('External id')
        launch = runtime.get(args.get('correlation'))
        op = ops.get(ext)
        host_ts = (launch['ts'] if launch is not None
                   else op['ts'] if op is not None else None)
        device.append({'name': e['name'], 'ts': e['ts'],
                       'dur': e.get('dur', 0), 'host_ts': host_ts,
                       'op': ext, 'launch': None if launch is None
                       else launch['name']})
    device.sort(key=lambda e: e['ts'])
    launches = collections.defaultdict(list)
    for op in sorted(ops.values(), key=lambda e: e['ts']):
        if op.get('cat') == 'user_annotation' and op['name'] in LAUNCHES:
            launches[op['name']].append(op)
    return Trace(device, ops, dict(regions), forward, dict(launches), host)


def region_steps(trace: Trace, region: str, launch: str | None = None) -> list:
    """The device events of each instance of ``region``, in device order:
    an event belongs to the instance whose host span holds its launch.
    With ``launch``, only the events of that runtime call (a replay's
    graph; the generators' seed and offset fills a replay launches before
    its graph are left out)."""
    spans = trace.regions.get(region, [])
    starts = [s for s, _ in spans]
    steps = [[] for _ in spans]
    for e in trace.events:
        if e['host_ts'] is None or (launch is not None
                                    and e['launch'] != launch):
            continue
        i = bisect.bisect_right(starts, e['host_ts']) - 1
        if i >= 0 and e['host_ts'] <= spans[i][1]:
            steps[i].append(e)
    return steps


class JoinError(ValueError):
    """The eager step and a replayed step launch different kernels."""


def join(reference: list, replay: list) -> None:
    """Hold a replayed step's device events against the eager step's,
    position by position: the same count and the same name at every
    position, or JoinError naming the first position that differs."""
    for i, (a, b) in enumerate(zip(reference, replay)):
        if a['name'] != b['name']:
            break
    else:
        if len(reference) == len(replay):
            return
        i = min(len(reference), len(replay))
    names = [[e['name'][:60] for e in events[max(0, i - 2):i + 3]]
             for events in (reference, replay)]
    raise JoinError(f'the eager step has {len(reference)} device events, the '
                    f'replayed step {len(replay)}; they part at position {i}: '
                    f'eager {names[0]}, replay {names[1]}')


def launching_ops(trace: Trace, step: list, span) -> list:
    """The operator that launched each device event of a step (host
    ``span``): the operator the event's External id names; for a hand
    kernel, whose ``ctypes`` launch the runtime ties to no region, the
    k-th launch region of its C entry in the span for its kernel's k-th
    event."""
    regions = {c: iter([op for op in trace.launches.get(c, [])
                        if span[0] <= op['ts'] <= span[1]])
               for c in LAUNCHES}
    out = []
    for e in step:
        entry = next((c for c, k in LAUNCHES.items() if k in e['name']), None)
        out.append(trace.ops.get(e['op']) if entry is None
                   else next(regions[entry], None))
    return out


def attribute(trace: Trace, step: list, span) -> list:
    """The source (the program's frames joined outer to inner, a backward
    operator's from its forward operator) of each device event of the
    eager step."""
    out = []
    for op in launching_ops(trace, step, span):
        if op is None:
            out.append('')
        elif op['seq'] is not None:
            out.append(' > '.join(trace.forward.get(op['seq']) or op['frames']))
        else:
            out.append(' > '.join(op['frames']))
    return out


def eager_step(trace: Trace):
    """(the one eager step's device events, its host span)."""
    eager = region_steps(trace, EAGER_STEP)
    if len(eager) != 1:
        raise JoinError(f'{len(eager)} eager steps in the reference trace')
    return eager[0], trace.regions[EAGER_STEP][0]


def replayed_steps(trace: Trace, region: str = REPLAY_STEP,
                   within=None) -> list:
    """The device events of each replay of a graph (region ``region``);
    with ``within``, a host span, only the replays inside it."""
    steps = region_steps(trace, region, GRAPH_LAUNCH)
    if within is None:
        return steps
    return [s for s, (a, b) in zip(steps, trace.regions.get(region, []))
            if within[0] <= a and b <= within[1]]


def replay_counts(trace: Trace, region: str = REPLAY_STEP) -> list:
    """The sorted distinct numbers of device events of the replays: one
    number where the profiler lost none."""
    return sorted({len(r) for r in replayed_steps(trace, region)})


def source_us(ref: Trace, chunk: Trace, steps: int) -> dict:
    """Device microseconds over the ``steps`` replayed steps of the
    chunk's traced stretch (``WINDOW``) by source bucket (``OUTSIDE``: the
    device time of what the stretch launched outside them), each replayed
    step joined to the eager step of ``ref``."""
    eager, span = eager_step(ref)
    window = window_span(chunk)
    replays = replayed_steps(chunk, within=window)
    if len(replays) != steps:
        raise JoinError(f'{len(replays)} replayed steps in a chunk of {steps}')
    for replay in replays:
        join(eager, replay)
    buckets = [source_bucket_of(s) for s in attribute(ref, eager, span)]
    out = collections.Counter()
    for replay in replays:
        for e, b in zip(replay, buckets):
            out[b] += e['dur']
    inside = sum(out.values())
    out[OUTSIDE] += sum(e['dur'] for e in chunk.events
                        if e['host_ts'] is not None
                        and window[0] <= e['host_ts'] <= window[1]) - inside
    return dict(out)


# ------------------------------------------------- busy time and breakdown

def window_span(trace: Trace):
    """The host span of the benchmark's traced stretch."""
    spans = trace.regions.get(WINDOW, [])
    if len(spans) != 1:
        raise ValueError(f'{len(spans)} regions {WINDOW!r} in the trace')
    return spans[0]


def busy_intervals(trace: Trace, span) -> list:
    """The merged intervals in which a device operation ran, clipped to
    ``span``."""
    t0, t1 = span
    merged: list = []
    for e in trace.events:
        a, b = max(e['ts'], t0), min(e['ts'] + e['dur'], t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_and_window_s(trace: Trace):
    """(seconds in which the device ran an operation, the stretch's
    seconds), over the benchmark's traced stretch."""
    span = window_span(trace)
    busy = sum(b - a for a, b in busy_intervals(trace, span))
    return busy / 1e6, (span[1] - span[0]) / 1e6


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations with the most time in the stretch, and its
    longest idle gaps summed by what the host was doing: the innermost
    host event (operator, region or runtime call) over the gap's middle."""
    span = window_span(trace)
    ops = collections.Counter()
    for e in trace.events:
        if span[0] <= e['ts'] < span[1]:
            ops[e['name']] += e['dur']
    busy = busy_intervals(trace, span)
    gaps, prev = [], span[0]
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if span[1] > prev:
        gaps.append((prev, span[1]))
    host = sorted((e for e in trace.host if e['name'] != WINDOW
                   and e['ts'] < span[1]
                   and e['ts'] + e.get('dur', 0) > span[0]),
                  key=lambda e: e['ts'])
    starts = [e['ts'] for e in host]
    idle = collections.Counter()
    for a, b in gaps:
        mid = 0.5 * (a + b)
        best = None
        for e in host[:bisect.bisect_right(starts, mid)]:
            if e['ts'] + e.get('dur', 0) >= mid and (
                    best is None or e.get('dur', 0) < best.get('dur', 0)):
                best = e
        idle[best['name'] if best is not None else 'python'] += b - a
    return {'device_ops': [[n, us / 1e6] for n, us in ops.most_common(top)],
            'idle_gaps': [[n, us / 1e6] for n, us in idle.most_common(top)]}
