"""Captured CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs its hot programs compiled: a chunk of optimizer
steps as one ``lax.scan`` (``deepcgp_tpu/training/trainer.py``
``run_chunk``), the eval as one scan (``predict_probs_scanned``) and the
Predictor's batch as one jitted function (``deepcgp_tpu/serving.py``).
The port captures the same work into ``torch.cuda.CUDAGraph``s and
replays them from Python: one host call launches every kernel the capture
recorded.

What a replay reads: every tensor the capture read, at the address it had
then, and no Python value.  So a captured function reads only tensors
that keep their storage (a ``TrainState`` is written in place, a batch is
copied into a static input), and every decision it made on the host --
shapes, routes, cluster sizes, the number of draws -- is baked in.  A
:class:`GraphCache` keys each graph by everything its capture baked in:
the function, its static arguments and the identity (address, shape,
dtype) of every tensor it reads (:func:`tensor_key`); another key
captures anew.

Random draws come from generators registered with the graph
(``CUDAGraph.register_generator_state``): a replay reads the generator's
seed and offset as it starts and advances the offset by the graph's
draws, so its draws are the eager ones from the same state, and a
``manual_seed`` or ``set_state`` between replays takes effect.

The first call of a key runs the function eagerly on the cache's side
stream -- real work, whose result it returns -- and then captures it.
The eager run builds the kernels, loads their libraries and fills every
host-side cache (``cuda_linalg._max_clusters``, the Gauss-Hermite points,
...) outside the capture; the capture itself runs no kernel.  The eager
run builds ``cuda_cross``'s padded copies of Z as the capture does, on
every call, so it launches the kernels a replay launches, in their order
(the span ``graph eager <name>`` of a trace or a recording; a replay is
``graph replay <name>``, whose graph's kernels follow the generators'
seed and offset fills that every replay launches first; the capture is
``graph capture <name>``, and counts in
``profiling.COUNTERS['graph captures']``).  The kernel
wrappers' launch counters count the Python calls a capture makes: those
counts are taken back and added again on every replay
(:func:`counts_taken_back`, :meth:`Graph.replay`), so each counter stays
the number of its kernel's launches on the device.  A replay writes
tensors behind their version counters' back, so it also drops the
host-side copies keyed by them (``cuda_cross.drop_padded_copies``).

The graphs of one cache share a private memory pool, in which one graph
may reuse another's intermediate memory: a caller reads a graph's
outputs (in stream order) before it replays another graph of the cache.

Under a mesh (``parallel.sharding``) the collectives of a step are
captured with it, as the JAX package jits its sharded programs: NCCL
launches each on its own stream, joined to the capturing stream by
events, so the graph holds the kernels of every rank's collective and a
replay runs them with the rest.  The capture keeps the default, strictest
mode ('global'); NCCL's collectives and its watchdog thread capture in
it, as they do in 'thread_local', on the H100.  The eager run before each capture is
where NCCL creates each group's communicator, which it cannot do inside
a capture.  Every graph's key holds the active mesh (:func:`mesh_key`):
a graph captured without a mesh skips every collective, and one captured
under a mesh runs its groups'.  Each rank replays its graphs in the same
order, as it runs its eager collectives.  The collectives count in
``sharding.collective.launches``, taken back and added per replay as the
kernel counters are.

A capture that fails raises; nothing falls back to eager.  Eager is the
CPU's way, a gloo mesh's (gloo's collectives run on the host and cannot
be captured) or the caller's choice (``graphed=False``), as
:func:`use_graphs` decides.
"""

from __future__ import annotations

import contextlib
import time
import weakref

import torch
import torch.distributed as dist

from deepcgp_tpu_torch.ops import cuda_adam, cuda_cross
from deepcgp_tpu_torch.parallel import sharding
from deepcgp_tpu_torch.utils import profiling


def counted() -> tuple:
    """The kernel wrappers whose ``.launches`` count their launches: the
    model's kernels and the Adam step's (``cuda_adam.adam_step``, counted
    apart from the model's, whose launches a path has by its shapes)."""
    return tuple(profiling.kernel_counters().values()) + (
        cuda_adam.adam_step,)


@contextlib.contextmanager
def counts_taken_back(fns):
    """Inside the block the counters of ``fns`` count as usual; on exit
    each is set back to its value at entry, and the yielded list holds
    what the block added to each (the launches of one replay)."""
    before = [fn.launches for fn in fns]
    added: list = []
    try:
        yield added
    finally:
        added[:] = [fn.launches - b for fn, b in zip(fns, before)]
        for fn, b in zip(fns, before):
            fn.launches = b


def use_graphs(graphed, device, what: str) -> bool:
    """Whether ``what`` runs as replayed graphs: ``graphed=None`` means
    yes on a CUDA device with no active mesh (``sharding.active_mesh()``)
    or under a mesh whose groups (and process group) are all NCCL's, and
    no on the CPU or under a gloo mesh; False means eager; True means
    graphed, and raises on the CPU or under a gloo mesh (gloo's
    collectives are not captured).  A one-rank mesh without a process
    group has no collectives and counts as no mesh."""
    cuda = torch.device(device).type == 'cuda'
    mesh = sharding.active_mesh()
    gloo = mesh is not None and mesh.distributed and {
        dist.get_backend(g) for g in (None, mesh.data_group,
                                      mesh.model_group)} != {'nccl'}
    if graphed is None:
        return cuda and not gloo
    if graphed and not cuda:
        raise ValueError(f'{what}: graphed=True needs a CUDA device, '
                         f'not {device}')
    if graphed and gloo:
        raise ValueError(f'{what}: graphed=True under a gloo mesh; its '
                         'collectives run on the host and are not '
                         'captured, so it runs eager')
    return bool(graphed)


def mesh_key() -> tuple | None:
    """The active mesh as a graph key holds it: its shape, this rank and
    its groups (None without a mesh)."""
    mesh = sharding.active_mesh()
    if mesh is None:
        return None
    return (mesh.data, mesh.model, mesh.rank, mesh.world_size,
            mesh.data_group, mesh.model_group)


def tensor_key(tensors) -> tuple:
    """The identity of the tensors a capture reads: (address, shape,
    dtype) each."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


def module_tensors(module: torch.nn.Module) -> list:
    return list(module.parameters()) + list(module.buffers())


def region(kind: str, key) -> str:
    """The span of a graph's eager run (``kind`` 'eager'), of its capture
    ('capture') or of a replay ('replay'), named by its key's first
    element: 'graph replay step' is one optimizer step of ``run_chunk``."""
    return f'graph {kind} {key[0] if isinstance(key, tuple) else key}'


class Graph:
    """One captured function: its graph, its static inputs and outputs,
    the launches one replay makes of each counted kernel, and the span of
    a replay."""

    def __init__(self, graph, inputs, outputs, launches, fns,
                 region='graph replay'):
        self.region = region
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.fns = fns

    def replay(self, request=None):
        """Launch the graph on the current stream; returns its static
        outputs, which the next replay overwrites.  A replay writes
        tensors without bumping their version counters, so the host-side
        copies keyed by them (``cuda_cross``'s padded Z) are dropped.
        The replay is a span carrying ``request``, with its device work."""
        with profiling.annotate(self.region, request=request, device=True):
            self.graph.replay()
        cuda_cross.drop_padded_copies()
        for fn, n in zip(self.fns, self.launches):
            fn.launches += n
        return self.outputs


class GraphCache:
    """The graphs of one owner (a TrainState, a model's evals, a
    Predictor), one private memory pool and one side stream for their
    warm-ups and captures, and the generators registered with them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.graphs: dict = {}
        self.generators: dict = {}
        self.buffers: dict = {}
        self.captures = 0
        self.capture_seconds = 0.0

    def generator(self, name: str) -> torch.Generator:
        """A generator of this cache's that keeps its identity across
        calls, so that graphs registered with it stay valid; seed it
        before each use."""
        g = self.generators.get(name)
        if g is None:
            g = self.generators[name] = torch.Generator(device=self.device)
        return g

    def buffer(self, name: str, make) -> torch.Tensor:
        """A tensor of this cache's, made once by ``make()`` outside any
        capture, so that every graph that reads or writes it keeps its
        storage."""
        t = self.buffers.get(name)
        if t is None:
            t = self.buffers[name] = make()
        return t

    def run(self, key, fn, inputs=(), generators=(), request=None):
        """``fn(*inputs)`` (its outputs: tensors, or None) through the graph
        of ``key``: a replay after the inputs are copied into the static
        ones; or, the first time, an eager run on the side stream followed
        by the capture of ``fn`` on static copies of the inputs, with
        ``generators`` registered (every generator ``fn`` draws from).
        The replay or the eager run is a span carrying ``request``."""
        entry = self.graphs.get(key)
        if entry is not None:
            for static, x in zip(entry.inputs, inputs):
                static.copy_(x)
            return entry.replay(request)
        static = [x.clone() for x in inputs]
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            with profiling.annotate(region('eager', key), request=request,
                                    device=True), \
                    cuda_cross.built_every_call():
                out = fn(*static)
            # A capture cannot free memory: the cached blocks go back to
            # the device first, so that the pool can take them.
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            with profiling.annotate(region('capture', key)):
                self.graphs[key] = self._capture(fn, static, generators,
                                                 region('replay', key))
        current.wait_stream(self.stream)
        return out

    def _capture(self, fn, static, generators, name) -> Graph:
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        fns = counted() + (sharding.collective,)
        t = time.perf_counter()
        with counts_taken_back(fns) as launches:
            graph.capture_begin(pool=self.pool)
            try:
                outputs = fn(*static)
            except BaseException as err:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                err.add_note('raised while capturing a CUDA graph: the '
                             'captured function must launch on the current '
                             'stream and never wait on the host')
                raise
            graph.capture_end()
        self.captures += 1
        profiling.COUNTERS['graph captures'] += 1
        self.capture_seconds += time.perf_counter() - t
        return Graph(graph, static, outputs, launches, fns, name)


_MODEL_CACHES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def model_cache(model: torch.nn.Module) -> GraphCache:
    """The graph cache of a model's evaluations, alive as long as the
    model (held weakly, so a copy of the model does not carry it)."""
    cache = _MODEL_CACHES.get(model)
    if cache is None:
        cache = _MODEL_CACHES[model] = GraphCache(
            next(iter(model.parameters())).device)
    return cache
