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
...) outside the capture; the capture itself runs no kernel.  The kernel
wrappers' launch counters count the Python calls a capture makes: those
counts are taken back and added again on every replay
(:func:`counts_taken_back`, :meth:`Graph.replay`), so each counter stays
the number of its kernel's launches on the device.  A replay writes
tensors behind their version counters' back, so it also drops the
host-side copies keyed by them (``cuda_cross.drop_padded_copies``).

The graphs of one cache share a private memory pool, in which one graph
may reuse another's intermediate memory: a caller reads a graph's
outputs (in stream order) before it replays another graph of the cache.

A capture that fails raises; nothing falls back to eager.  Eager is the
CPU's way, a mesh's (its collectives are not captured) or the caller's
choice (``graphed=False``), as :func:`use_graphs` decides.
"""

from __future__ import annotations

import contextlib
import time
import weakref

import torch

from deepcgp_tpu_torch.ops import cuda_cross, cuda_linalg, cuda_patches
from deepcgp_tpu_torch.parallel import sharding


def counted() -> tuple:
    """The kernel wrappers whose ``.launches`` count their launches."""
    return (cuda_linalg.chol_inv_base, cuda_linalg.chol_inv_base_upper,
            cuda_linalg.tri_inv_base, cuda_cross.conv_rbf_cross,
            cuda_cross.conv_rbf_cross_bwd,
            cuda_patches.extract_patches_transposed,
            cuda_patches.col2im_transposed)


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
    and no on the CPU or under a mesh; False means eager; True means
    graphed, and raises on the CPU or under a mesh (the collectives of a
    mesh are not captured)."""
    cuda = torch.device(device).type == 'cuda'
    meshed = sharding.active_mesh() is not None
    if graphed is None:
        return cuda and not meshed
    if graphed and not cuda:
        raise ValueError(f'{what}: graphed=True needs a CUDA device, '
                         f'not {device}')
    if graphed and meshed:
        raise ValueError(f'{what}: graphed=True under a mesh; its '
                         'collectives are not captured, so it runs eager')
    return bool(graphed)


def tensor_key(tensors) -> tuple:
    """The identity of the tensors a capture reads: (address, shape,
    dtype) each."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


def module_tensors(module: torch.nn.Module) -> list:
    return list(module.parameters()) + list(module.buffers())


class Graph:
    """One captured function: its graph, its static inputs and outputs,
    and the launches one replay makes of each counted kernel."""

    def __init__(self, graph, inputs, outputs, launches, fns):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.fns = fns

    def replay(self):
        """Launch the graph on the current stream; returns its static
        outputs, which the next replay overwrites.  A replay writes
        tensors without bumping their version counters, so the host-side
        copies keyed by them (``cuda_cross``'s padded Z) are dropped."""
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

    def run(self, key, fn, inputs=(), generators=()):
        """``fn(*inputs)`` (its outputs: tensors, or None) through the graph
        of ``key``: a replay after the inputs are copied into the static
        ones; or, the first time, an eager run on the side stream followed
        by the capture of ``fn`` on static copies of the inputs, with
        ``generators`` registered (every generator ``fn`` draws from)."""
        entry = self.graphs.get(key)
        if entry is not None:
            for static, x in zip(entry.inputs, inputs):
                static.copy_(x)
            return entry.replay()
        static = [x.clone() for x in inputs]
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn(*static)
            # A capture cannot free memory: the cached blocks go back to
            # the device first, so that the pool can take them.
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            self.graphs[key] = self._capture(fn, static, generators)
        current.wait_stream(self.stream)
        return out

    def _capture(self, fn, static, generators) -> Graph:
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        fns = counted()
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
        self.capture_seconds += time.perf_counter() - t
        return Graph(graph, static, outputs, launches, fns)


_MODEL_CACHES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def model_cache(model: torch.nn.Module) -> GraphCache:
    """The graph cache of a model's evaluations, alive as long as the
    model (held weakly, so a copy of the model does not carry it)."""
    cache = _MODEL_CACHES.get(model)
    if cache is None:
        cache = _MODEL_CACHES[model] = GraphCache(
            next(iter(model.parameters())).device)
    return cache
