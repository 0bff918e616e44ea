"""Per-op roofline of a graphed training chunk (counterpart of the JAX
repository's ``tools/roofline.py``).

Builds a configuration (``--config``: the JAX tool's ``flagship``,
``natgrad``, ``m1024`` and ``m1024-natgrad``, and ``mnist-conv``, ``fm32``
and ``deep3``), profiles the first graphed ``run_chunk`` call of its
fresh state -- one eager step, then that step's capture
(``training/graphs.py``) -- with shapes and Python stacks, warms up,
times one steady chunk of ``--steps`` replayed steps untraced, and
traces one more.  From the chunk's Chrome trace it sums the device
events (kernels, copies, sets; the device spans of annotated regions are
not device work) two ways:

* ``BUCKETS``, by kernel name, first match wins: K1-K7 by the names in
  ``utils.profiling.KERNEL_NAMES``, the Adam step's two kernels
  (``ops/cuda_adam.py``), cuBLAS's ``align1`` SIMT products
  apart from the other products, float64 kernels, ``tril``, reductions,
  copies and sets, elementwise kernels;
* ``SOURCE_BUCKETS``, by the port's function that launched the kernel.
  A replay's kernels carry no operator, so each replayed step's graph
  kernels are joined, position by position, to the eager step's (the
  eager run builds what the capture builds: ``training/graphs.py``;
  the seed and offset fills a replay launches before its graph, the
  chunk's bookkeeping and NatGrad's final check count as 'outside the
  steps'), where each
  kernel maps to the operator that launched it and that operator's
  ``deepcgp_tpu_torch`` frames (a backward operator to its forward's, by
  autograd's sequence number).  The join raises where a name or the count
  differs (:func:`join`).

On the CPU (``main(argv, device='cpu')``) the events are the trace's leaf
operators and the steps are eager, each in a region of its own.

Output: the bucket tables and the top 30 kernels a step, as the JAX tool
prints them; ``--bucket-detail`` the top kernels of one bucket;
``--parse-only`` re-buckets the traces saved under ``--trace-dir``
without the card.

    python -m deepcgp_tpu_torch.tools.roofline --config flagship
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import os
import re
import sys
import tempfile
import time
import types

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepcgp_tpu_torch import config as port_config
from deepcgp_tpu_torch.training import graphs, trainer
from deepcgp_tpu_torch.utils import flops, profiling

FLAGSHIP = dict(M='384,384', feature_maps='10', filter_sizes='5,5',
                strides='3,1', base_kernel='rbf', last_kernel='conv',
                white=False, identity_mean=False)
M1024 = dict(M='1024', feature_maps='', filter_sizes='5', strides='1',
             base_kernel='rbf', last_kernel='rbf', white=False,
             identity_mean=False)
# name: (builder flags, image, batch, optimizer).  The first four are the
# JAX tool's (tools/roofline.py:40-75); mnist-conv (the paper's MNIST
# single-layer ConvKernel, P = 576), fm32 and deep3 (3 layers, identity
# mean) are the JAX builder's too, with chip_smoke.py's flags.
CONFIGS = {
    'flagship': (FLAGSHIP, (32, 32, 3), 32, 'Adam'),
    'natgrad': (FLAGSHIP, (32, 32, 3), 32, 'NatGrad'),
    'm1024': (M1024, (28, 28, 1), 128, 'Adam'),
    'm1024-natgrad': (M1024, (28, 28, 1), 128, 'NatGrad'),
    'mnist-conv': (dict(M1024, last_kernel='conv'), (28, 28, 1), 32, 'Adam'),
    'fm32': (dict(FLAGSHIP, feature_maps='32'), (32, 32, 3), 32, 'Adam'),
    'deep3': (dict(FLAGSHIP, M='384,384,384', feature_maps='10,10',
                   filter_sizes='5,3,3', strides='2,1,1', identity_mean=True),
              (32, 32, 3), 32, 'Adam'),
}
NUM_SAMPLES, IMAGES = 10, 2048

# Device work in a Chrome trace.
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
# The region of a step: on the card the step graph's eager run and its
# replays (training/graphs.region); on the CPU each eager step.
EAGER_STEP = graphs.region('eager', ('step',))
REPLAY_STEP = graphs.region('replay', ('step',))
CPU_STEP = 'eager step'
# The runtime call that launches a replay's graph.
GRAPH_LAUNCH = 'cudaGraphLaunch'
# Traces of a chunk (and profiles of its eager step) before one whose
# steps hold different numbers of events fails the join.
TRACES = 6
# The hand kernels' launch regions (profiling.launch), by C entry point,
# and the device kernel each launches.
LAUNCHES = {'chol_factor_blocked': 'chol_factor_cluster_kernel',
            'chol_upper_blocked': 'chol_upper_cluster_kernel',
            'tri_inv_blocked': 'tri_inv_strip_kernel',
            'conv_rbf_cross': 'conv_rbf_cross_kernel',
            'conv_rbf_cross_bwd_image': 'bwd_image_kernel',
            'conv_rbf_cross_bwd_z': 'bwd_z_kernel',
            'extract_patches_transposed': 'extract_transposed_kernel',
            'col2im_transposed': 'col2im_transposed_kernel',
            'adam_all_finite': 'adam_finite_kernel',
            'adam_update': 'adam_update_kernel'}
# An aten operator's region under OpBytes: 'aten#<dispatch index>'.
OP_REGION = 'aten#'

# The hand kernels' buckets, by launch counter.
K_BUCKETS = {'chol_inv_base': 'K1 chol_factor',
             'chol_inv_base_upper': 'K2 chol_upper',
             'tri_inv_base': 'K3 tri_inv',
             'conv_rbf_cross': 'K4 conv_rbf_cross',
             'conv_rbf_cross_bwd': 'K5 conv_rbf_cross_bwd',
             'extract_patches_transposed': 'K6 extract_patches',
             'col2im_transposed': 'K7 col2im'}
# Bucket attribution by kernel name, first match wins: K1-K7 by their
# device names (``utils.profiling.KERNEL_NAMES``), then the library's.
BUCKETS = [(bucket, '|'.join(map(re.escape, profiling.KERNEL_NAMES[c])))
           for c, bucket in K_BUCKETS.items()] + [
    ('adam step', r'adam_finite_kernel|adam_update_kernel'),
    ('gemm simt align1', r'simt.*align1|align1.*simt'),
    ('float64', r'double|f64|dgemm|dsyrk|dtrsm|dpotrf|zgemm'),
    ('chol/solve library', r'trsm|potrf|potrs|trtri|getrf|cusolver|syevd'),
    ('gemm', r'gemm|gemv|gemk|splitKreduce|xmma|cutlass|dot_kernel|'
             r'reduce_1Block|_nn_|_nt_|_tn_|_tt_'),
    ('tril', r'tril|triu'),
    ('reduction', r'reduce|Reduce|SoftMax|softmax|scan|Scan|norm_kernel|'
                  r'argmax|max_kernel|sum_kernel|cub::'),
    ('copy/memset', r'Memcpy|Memset|copy|Copy|CatArray|cat_'),
    ('gather/scatter', r'index|Index|gather|scatter|take|put_'),
    ('random', r'distribution|philox|curand|random|normal_kernel'),
    ('elementwise', r'elementwise|Functor|vectorized|unrolled|fill|where|'
                    r'clamp|launch_kernel'),
]
# Bucket attribution by the port's frames that launched a kernel (outer to
# inner, 'module/file.py:function' joined by ' > '; a '$' anchors the
# innermost), first match wins: the counterpart of the JAX tool's metadata
# match.  'natgrad' comes first: everything the natural-gradient step runs
# (``optim.natgrad_step_with_backoff`` and what it calls, K2 and K3 of its
# solve too).
SOURCE_BUCKETS = [
    ('natgrad', r'optim\.py:natgrad'),
    ('conv-Kuf', r'(conv_kernels|base_kernels|distances|cuda_cross|'
                 r'cuda_patches|ops/patches|views|mean_functions)\.py'),
    ('chol/solve', r'linalg\.py:(chol|cholesky|tri_inv|upper|_bigchol)|'
                   r'cuda_linalg\.py'),
    ('kl', r'linalg\.py:(_?gauss_kl|syrk_sum)|layers\.py:KL|dgp\.py:prior_kl'),
    ('qsqrt-term', r'conditional\.py'),
    ('optimizer', r'optim\.py|cuda_adam\.py|trainer\.py:train_step$'),
    ('sampling/likelihood', r'likelihoods\.py|layers\.py:_sample|'
                            r'dgp\.py:propagate'),
    ('elbo', r'dgp\.py|trainer\.py:loss_and_grads$'),
    ('batch', r'trainer\.py:(batch|step|run_chunk)$'),
]
OUTSIDE = 'outside the steps'


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def bucket_of(name: str) -> str:
    for bucket, pat in BUCKETS:
        if re.search(pat, name):
            return bucket
    return 'other'


def source_bucket_of(source: str) -> str:
    for bucket, pat in SOURCE_BUCKETS:
        if re.search(pat, source):
            return bucket
    return 'other'


@dataclasses.dataclass
class Run:
    """A built configuration's training state and data."""
    state: trainer.TrainState
    config: trainer.TrainConfig
    X: torch.Tensor
    Y: torch.Tensor

    @property
    def graphed(self) -> bool:
        return self.X.device.type == 'cuda'


def build(config: str, device=None, seed: int = 0) -> Run:
    """The configuration on random images and labels from ``seed``."""
    from deepcgp_tpu_torch.models.builder import build_model
    flags, image, batch, optimizer = CONFIGS[config]
    device = port_config.default_device(device)
    rng = np.random.RandomState(seed)
    X = rng.randn(IMAGES, *image).astype(np.float32)
    Y = rng.randint(0, 10, size=(IMAGES, 1))
    t0 = time.time()
    model = build_model(types.SimpleNamespace(**flags, num_samples=NUM_SAMPLES),
                        image, images=X,
                        generator=torch.Generator().manual_seed(seed),
                        device=device)
    _log(f"model built in {time.time() - t0:.1f}s")
    tc = trainer.TrainConfig(optimizer=optimizer, lr=0.01,
                             lr_decay_steps=100000, gamma=0.001,
                             batch_size=batch)
    state = trainer.init_state(model, tc, seed=seed + 1)
    return Run(state, tc, torch.as_tensor(X.reshape(IMAGES, -1), device=device),
               torch.as_tensor(Y, device=device))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


class OpBytes(TorchDispatchMode):
    """A dispatch mode that logs every aten operator's output and input
    bytes in dispatch order, ``ops`` [(name, output bytes, input bytes)],
    and runs it inside a trace region 'aten#<index>', so a kernel's
    launching operator finds its entry.  A capture (a graph's second run
    of the step) is not logged."""

    def __init__(self):
        super().__init__()
        self.ops: list = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return func(*args, **kwargs)
        index = len(self.ops)
        with torch.profiler.record_function(f'{OP_REGION}{index}'):
            out = func(*args, **kwargs)
        self.ops.append((func.__name__, _nbytes(out),
                         _nbytes(list(args) + list(kwargs.values()))))
        return out


@dataclasses.dataclass
class Reference:
    """The eager step the replays are held against: its trace, the
    operators' bytes (OpBytes) and the hand kernels' launches
    (profiling.observe_launches) in order."""
    path: str
    ops: list
    launches: list
    rounds: int


def reference_step(run: Run, trace_dir: str) -> Reference:
    """After one eager step, profile (record_shapes, with_stack) the
    first graphed call of a fresh graph cache: its eager run of one step
    precedes the step's capture.  On the CPU, one eager step in a region
    of its own.  A profiled round short of the counters' launches starts a
    new cache."""
    state, tc = run.state, run.config
    # One eager step first fills the host-side caches (the Gauss-Hermite
    # points on the device, cuBLAS's handle), whose one-time copies would
    # otherwise sit in the reference step alone.
    trainer.run_chunk(state, tc, run.X, run.Y, 1, graphed=False)
    out: dict = {}

    def fn():
        with profiling.observe_launches() as launches:
            if run.graphed:
                state.graphs = None
                with OpBytes() as ops:
                    trainer.run_chunk(state, tc, run.X, run.Y, 1,
                                      graphed=True)
            else:
                ops = _cpu_step(run)
        out.update(ops=ops.ops, launches=launches)

    prof, _, rounds, _ = profiling.profile_counted(
        fn, log_dir=os.path.join(trace_dir, 'reference'), record_shapes=True,
        with_stack=True)
    return Reference(prof.trace_path, out['ops'], out['launches'], rounds)


def _cpu_step(run: Run) -> OpBytes:
    """One eager step in a region of its own, under OpBytes: a dispatch
    mode changes which host operators autograd and tensor creation run
    (``add`` for ``add_``, ``lift_fresh``), so every step it is held
    against runs under one too."""
    with profiling.annotate(CPU_STEP), OpBytes() as ops:
        trainer.run_chunk(run.state, run.config, run.X, run.Y, 1,
                          graphed=False)
    return ops


def chunk(run: Run, steps: int):
    """``steps`` steps: one graphed run_chunk on the card; on the CPU eager
    steps, each in a region of its own (:func:`_cpu_step`)."""
    if run.graphed:
        trainer.run_chunk(run.state, run.config, run.X, run.Y, steps)
        torch.cuda.synchronize()
        return
    for _ in range(steps):
        _cpu_step(run)


def build_and_warm(config: str, steps: int, device=None,
                   trace_dir: str | None = None):
    """Build, profile the reference step (capturing), warm up ``steps``
    steps.  Returns (run, reference)."""
    run = build(config, device)
    trace_dir = trace_dir or default_trace_dir(config)
    t0 = time.time()
    ref = reference_step(run, trace_dir)
    chunk(run, steps)
    _log(f"warmup (capture + {steps} steps) in {time.time() - t0:.1f}s")
    return run, ref


def traced_chunk(run: Run, steps: int, trace_dir: str):
    """One chunk of ``steps`` under the profiler, in rounds until its
    recorded launches match the counters.  Returns (trace path, launches,
    rounds, the profiler's device total in us)."""
    prof, _, rounds, made = profiling.profile_counted(
        lambda: chunk(run, steps), log_dir=os.path.join(trace_dir, 'chunk'))
    total = sum(e.self_device_time_total
                for e in profiling.device_entries(prof))
    return prof.trace_path, made, rounds, total


def default_trace_dir(config: str) -> str:
    return os.path.join(tempfile.gettempdir(), 'deepcgp_torch_roofline',
                        config)


# ------------------------------------------------------------ trace parsing
_FRAME = re.compile(r'deepcgp_tpu_torch/(\S+\.py)\((\d+)\): (\S+)')


@dataclasses.dataclass
class Trace:
    """The device events of a Chrome trace, with the host operators that
    launched them.  ``events``: dicts name, ts, dur, host_ts (the host
    time of the launch), op (the External id of the launching operator).
    ``ops``: External id -> operator dict with 'frames' (the port's
    enclosing frames, outer to inner), 'seq' (the autograd sequence
    number of the enclosing backward function, or None), 'region' (the
    index of the enclosing 'aten#' region, or None).  ``regions``: name
    -> sorted [(start, end)] of every user annotation; ``launches``: C
    entry -> its hand-kernel launch regions' operator dicts, sorted."""
    path: str
    events: list
    ops: dict
    regions: dict
    forward: dict        # sequence number -> frames of its forward operator
    launches: dict

    @property
    def total_us(self) -> float:
        return sum(e['dur'] for e in self.events)


def _sweep(host: list):
    """Annotate each operator of one thread (sorted by start, outer first)
    with its enclosing frames, backward function and aten# region."""
    stack: list = []
    for e in host:
        end = e['ts'] + e.get('dur', 0)
        while stack and stack[-1][1] <= e['ts']:
            stack.pop()
        if e.get('cat') in ('cpu_op', 'user_annotation'):
            frames, seq, region = [], None, None
            for s, _ in stack:
                if s.get('cat') == 'python_function':
                    m = _FRAME.search(s['name'])
                    # The measurement's own frames (a launch region, the
                    # dispatch mode) name no source.
                    if m and not m.group(1).startswith(
                            ('tools/', 'utils/profiling.py')):
                        frames.append(f'{m.group(1)}:{m.group(3)}')
                elif s['name'].startswith('autograd::engine::evaluate_function'):
                    seq = s['args'].get('Sequence number')
                elif s['name'].startswith(OP_REGION):
                    region = int(s['name'][len(OP_REGION):])
            if e['name'].startswith(OP_REGION):
                region = int(e['name'][len(OP_REGION):])
            e['frames'], e['seq'], e['region'] = frames, seq, region
            e['leaf'] = True
            if e.get('cat') == 'cpu_op':
                for s, _ in reversed(stack):
                    if s.get('cat') == 'cpu_op':
                        s['leaf'] = False
                        break
        stack.append((e, end))


def parse_trace(path: str, cpu: bool = False) -> Trace:
    """Read a Chrome trace exported by ``torch.profiler``: the device
    events (``DEVICE_CATS``; on the CPU, ``cpu=True``, the leaf operators)
    and the operators and frames that launched them."""
    with open(path) as f:
        events = [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X']
    host_cats = ('cpu_op', 'user_annotation', 'python_function')
    by_thread = collections.defaultdict(list)
    runtime = {}
    for e in events:
        cat = e.get('cat')
        if cat in host_cats:
            by_thread[(e['pid'], e['tid'])].append(e)
        elif cat in ('cuda_runtime', 'cuda_driver'):
            corr = (e.get('args') or {}).get('correlation')
            if corr is not None:
                runtime[corr] = e
    for host in by_thread.values():
        host.sort(key=lambda e: (e['ts'], -e.get('dur', 0)))
        _sweep(host)
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
    if cpu:
        for e in events:
            if e.get('cat') == 'cpu_op' and e.get('leaf'):
                ext = e['args'].get('External id')
                device.append({'name': e['name'], 'ts': e['ts'],
                               'dur': e.get('dur', 0), 'host_ts': e['ts'],
                               'op': ext, 'launch': None})
    else:
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
    return Trace(path, device, ops, dict(regions), forward, dict(launches))


def region_steps(trace: Trace, region: str, launch: str | None = None) -> list:
    """The device events of each instance of ``region``, in device order:
    an event belongs to the instance whose host span holds its launch.
    With ``launch``, only the events of that runtime call (a replay's
    graph: 'cudaGraphLaunch'; the generators' seed and offset fills that a
    replay launches before its graph are left out)."""
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
    """For each device event of the eager step (host ``span``):
    (source, direction, launching operator), source the port's frames
    joined outer to inner (a backward operator's from its forward
    operator)."""
    out = []
    for op in launching_ops(trace, step, span):
        if op is None:
            out.append(('', 'fwd', None))
        elif op['seq'] is not None:
            frames = trace.forward.get(op['seq']) or op['frames']
            out.append((' > '.join(frames), 'bwd', op))
        else:
            out.append((' > '.join(op['frames']), 'fwd', op))
    return out


@dataclasses.dataclass
class Roofline:
    """What the tool reads from one traced chunk."""
    config: str
    steps: int
    steps_per_s: float
    total_us: float
    device_total_us: float
    buckets: dict            # bucket -> us over the chunk
    counts: dict             # bucket -> events over the chunk
    per_name: dict           # kernel name -> us over the chunk
    sources: dict            # source bucket -> {'fwd': us, 'bwd': us}
    joined_steps: int
    step_events: int
    reference: list          # [(name, source, direction, op)] of the eager step
    position_us: list        # us over the chunk at each position of a step
    launches: dict
    rounds: dict


def eager_step(ref: Trace, cpu: bool):
    """(the eager step's device events, its host span)."""
    region = CPU_STEP if cpu else EAGER_STEP
    eager = region_steps(ref, region)
    if len(eager) != 1:
        raise JoinError(f'{len(eager)} eager steps in the reference trace')
    return eager[0], ref.regions[region][0]


def steps_of(ref: Trace, chunk_trace: Trace, cpu: bool):
    """(the eager step's device events, each replayed step's)."""
    return eager_step(ref, cpu)[0], region_steps(
        chunk_trace, CPU_STEP if cpu else REPLAY_STEP,
        None if cpu else GRAPH_LAUNCH)


def analyse(config: str, steps: int, ref: Trace, chunk_trace: Trace,
            cpu: bool, steps_per_s=float('nan'), launches=None,
            rounds=None, device_total_us=float('nan')) -> Roofline:
    """Bucket the chunk's device events and join each replayed step to
    the eager step (JoinError where they differ)."""
    eager, replays = steps_of(ref, chunk_trace, cpu)
    if len(replays) != steps:
        raise JoinError(f'{len(replays)} replayed steps in a chunk of {steps}')
    for replay in replays:
        join(eager, replay)
    sources_of = attribute(ref, eager, eager_step(ref, cpu)[1])
    buckets, counts = collections.Counter(), collections.Counter()
    per_name = collections.Counter()
    for e in chunk_trace.events:
        b = bucket_of(e['name'])
        buckets[b] += e['dur']
        counts[b] += 1
        per_name[e['name']] += e['dur']
    sources = collections.defaultdict(lambda: {'fwd': 0.0, 'bwd': 0.0})
    position_us = [0.0] * len(eager)
    for replay in replays:
        for i, (e, (source, direction, _)) in enumerate(zip(replay,
                                                            sources_of)):
            sources[source_bucket_of(source)][direction] += e['dur']
            position_us[i] += e['dur']
    in_steps = sum(position_us)
    sources[OUTSIDE]['fwd'] += chunk_trace.total_us - in_steps
    return Roofline(
        config, steps, steps_per_s, chunk_trace.total_us, device_total_us,
        dict(buckets), dict(counts), dict(per_name), dict(sources),
        len(replays), len(eager),
        [(e['name'], s, d, None if op is None else op['name'])
         for e, (s, d, op) in zip(eager, sources_of)],
        position_us, launches or {}, rounds or {})


def measure(config: str, steps: int, device=None, trace_dir=None):
    """Build, warm, time one steady chunk, trace one chunk; save what
    ``--parse-only`` needs under ``trace_dir``, and the Roofline read
    (:func:`read_result`).  Returns (Roofline, reference trace, Reference,
    run)."""
    trace_dir = trace_dir or default_trace_dir(config)
    run, ref = build_and_warm(config, steps, device, trace_dir)
    t0 = time.time()
    chunk(run, steps)
    wall = time.time() - t0
    _log(f"steady-state: {steps / wall:.1f} steps/s")
    cpu = not run.graphed
    ref_trace = parse_trace(ref.path, cpu)
    # The profiler can lose device events of any kernel, not only of the
    # hand kernels its rounds count, and a lost event never comes back as
    # another.  So a trace whose replayed steps hold fewer events than the
    # eager step is traced again, and an eager step with fewer than a
    # replayed step is profiled again (a new capture).
    for attempt in range(1, TRACES + 1):
        path, launches, rounds, device_total = traced_chunk(run, steps,
                                                            trace_dir)
        chunk_trace = parse_trace(path, cpu)
        eager, replays = steps_of(ref_trace, chunk_trace, cpu)
        counts = sorted({len(r) for r in replays})
        if counts == [len(eager)]:
            break
        _log(f"trace {attempt}: replayed steps of {counts} device events "
             f"against the eager step's {len(eager)}; tracing again")
        if len(eager) < counts[-1]:
            ref = reference_step(run, trace_dir)
            ref_trace = parse_trace(ref.path, cpu)
    min_bytes = flops.training_step_min_bytes(run.state.model,
                                              run.config.batch_size)
    meta = {'config': config, 'steps': steps, 'steps_per_s': steps / wall,
            'min_bytes': min_bytes,
            'cpu': cpu, 'launches': launches, 'device_total_us': device_total,
            'rounds': {'reference': ref.rounds, 'chunk': rounds,
                       'traces': attempt},
            'reference': ref.path, 'chunk': path, 'ops': ref.ops,
            'hand_launches': ref.launches}
    with open(os.path.join(trace_dir, 'meta.json'), 'w') as f:
        json.dump(meta, f)
    result = analyse(config, steps, ref_trace, chunk_trace, cpu,
                     steps / wall, launches, meta['rounds'], device_total)
    with open(os.path.join(trace_dir, 'roofline.json'), 'w') as f:
        json.dump(dataclasses.asdict(result), f)
    return result, ref_trace, ref, run


def read_meta(trace_dir: str) -> dict:
    """What :func:`measure` saved beside the traces."""
    with open(os.path.join(trace_dir, 'meta.json')) as f:
        return json.load(f)


def read_result(trace_dir: str) -> Roofline:
    """The Roofline :func:`measure` read, as it saved it."""
    with open(os.path.join(trace_dir, 'roofline.json')) as f:
        return Roofline(**json.load(f))


def load(trace_dir: str):
    """(Roofline, reference trace, meta) from a saved ``trace_dir``."""
    meta = read_meta(trace_dir)
    cpu = meta['cpu']
    ref_trace = parse_trace(meta['reference'], cpu)
    result = analyse(meta['config'], meta['steps'], ref_trace,
                     parse_trace(meta['chunk'], cpu), cpu,
                     meta['steps_per_s'], meta['launches'], meta['rounds'],
                     meta['device_total_us'])
    return result, ref_trace, meta


def report(r: Roofline, bucket_detail: str | None = None) -> None:
    """The JAX tool's tables, per step, in us and % of device time."""
    total, steps = r.total_us, r.steps
    print(f"== {r.config}: {r.steps_per_s:.1f} steps/s, "
          f"{total / steps:.1f} us/step device time ==")
    print("-- buckets (per step) --")
    for b, us in sorted(r.buckets.items(), key=lambda kv: -kv[1]):
        print(f"{b:24s} {us / steps:9.1f} us  {100 * us / total:5.1f}%  "
              f"{r.counts[b] / steps:7.1f} launches")
    print("-- by source function (per step; joined to the eager step) --")
    for b, d in sorted(r.sources.items(), key=lambda kv: -sum(kv[1].values())):
        us = d['fwd'] + d['bwd']
        print(f"{b:24s} {us / steps:9.1f} us  {100 * us / total:5.1f}%  "
              f"(fwd {d['fwd'] / steps:.1f}, bwd {d['bwd'] / steps:.1f})")
    source = {}
    for name, s, d, op in r.reference:
        source.setdefault(name, f"{d} {s.split(' > ')[-1]} ({op})")
    print("-- top 30 ops (per step) --")
    for name, us in sorted(r.per_name.items(), key=lambda kv: -kv[1])[:30]:
        print(f"{us / steps:9.1f} us  {100 * us / total:5.1f}%  {name[:80]}  "
              f"| {bucket_of(name)}; {source.get(name, OUTSIDE)[:110]}")
    if bucket_detail:
        print(f"-- top 25 ops in bucket '{bucket_detail}' --")
        rows = [(n, us) for n, us in sorted(r.per_name.items(),
                                            key=lambda kv: -kv[1])
                if bucket_of(n) == bucket_detail]
        for name, us in rows[:25]:
            print(f"{us / steps:9.1f} us  {100 * us / total:5.1f}%  "
                  f"{name[:140]}  | {source.get(name, OUTSIDE)[:110]}")


def main(argv=None, device=None) -> Roofline:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--config', default='flagship', choices=list(CONFIGS))
    ap.add_argument('--steps', type=int, default=200)
    ap.add_argument('--trace-dir', default=None,
                    help='where the traces go (default: '
                         '$TMPDIR/deepcgp_torch_roofline/<config>)')
    ap.add_argument('--bucket-detail', default=None,
                    help="also print the top kernels of this bucket "
                         "(e.g. elementwise)")
    ap.add_argument('--parse-only', action='store_true',
                    help="re-parse the traces saved under --trace-dir "
                         "without touching the card")
    args = ap.parse_args(argv)
    trace_dir = args.trace_dir or default_trace_dir(args.config)
    if args.parse_only:
        result, _, _ = load(trace_dir)
    else:
        result, _, _, _ = measure(args.config, args.steps, device, trace_dir)
    _log(f"trace under {trace_dir}; device total {result.total_us / 1e3:.3f} "
         f"ms over {result.steps} steps (the profiler's: "
         f"{result.device_total_us / 1e3:.3f}); {result.joined_steps} steps "
         f"joined at {result.step_events} events each; launches "
         f"{result.launches}; profiled rounds {result.rounds}")
    report(result, args.bucket_detail)
    return result


if __name__ == '__main__':
    main()
