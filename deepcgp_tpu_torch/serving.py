"""Inference / serving layer (counterpart of ``deepcgp_tpu/serving.py``).

``Predictor`` serves class probabilities, labels and predictive
log-densities from a model loaded from a reference-format snapshot plus the
flags recorded in the run's ``options.toml``.  Requests are padded to whole
batches and move to the card in one transfer; every batch is enqueued
before one ``torch.cuda.synchronize()`` per request.  Monte-Carlo draws
come from a ``torch.Generator`` seeded from ``seed`` and the batch count,
so answers are reproducible for a given seed (the stream is not the JAX
package's).

On a CUDA device, with no mesh or under a mesh of NCCL groups, each
padded batch is a replayed CUDA graph (``training.graphs``), the
counterpart of the JAX package's jitted ``_probs`` and ``_dens``: one
graph per entry point, batch shape and mesh, captured after the first
such batch ran eagerly, reading the model's parameters where they lie and
drawing from one persistent generator that is re-seeded before each
replay exactly as the eager batch's generator is seeded; under a mesh the
graph ends in the gather of the batch's rows.  ``graphed=False`` serves
eagerly; the CPU and a gloo mesh always do.

With ``mesh`` (a ``parallel.mesh.Mesh`` or a spec such as 'data=2'),
every rank of the mesh serves the same request with the same model:
each batch's rows split over the data ranks (and the patches or GPs over
the model ranks, ``parallel.sharding``), the batch's draws are the
single-process ones, and the answers are gathered, so every rank returns
the whole [N, K].

Each request is a span of ``utils.profiling`` (``predict_proba`` or
``log_density``, carrying the Predictor's request count) over its
phases: ``serve prepare`` (flatten, standardize), ``serve h2d`` (pad and
move to the card), ``serve key`` (the graph key's walk over the model's
tensors), each batch's replay (``graph replay <kind>``; eager: ``serve
batch``), ``serve wait`` (the synchronize) and ``serve finish`` (the
copies out and back to the host).  A trace or a recording names the
host's time and the card's idle time by them.
"""

from __future__ import annotations

import os
import tomllib
import types

import numpy as np
import torch

from deepcgp_tpu_torch import config
from deepcgp_tpu_torch.models.builder import build_model, parse_ints
from deepcgp_tpu_torch.parallel import mesh as mesh_lib
from deepcgp_tpu_torch.parallel import multihost, sharding
from deepcgp_tpu_torch.training import graphs
from deepcgp_tpu_torch.utils import checkpoint, profiling


class Predictor:
    """Batched, pad-to-shape prediction server."""

    def __init__(self, model, *, batch_size: int = 32, num_samples: int = 5,
                 seed: int = 0, preprocessing: dict | None = None,
                 device=None, mesh=None, graphed: bool | None = None):
        self.device = config.default_device(device)
        if isinstance(mesh, str) and mesh:
            mesh = mesh_lib.make_mesh(mesh)
        self.mesh = mesh or None
        if self.mesh is not None and batch_size % self.mesh.data:
            raise ValueError(f'batch_size {batch_size} does not split over '
                             f'the data axis of size {self.mesh.data}')
        model_device = model.layers[0].Z.device
        if model_device.type != self.device.type:
            raise ValueError(f'model is on {model_device}, Predictor on '
                             f'{self.device}')
        self.model = model
        self.dtype = model.layers[0].Z.dtype
        self.batch_size = batch_size
        self.num_samples = num_samples
        self.seed = seed
        # {'mean': [D], 'scale': [D]} for raw inputs (from_run_dir loads it
        # from the run's preprocessing.npz).
        self.preprocessing = preprocessing
        self._calls = 0
        self._requests = 0
        # None: graphed on a CUDA device without a mesh or under an NCCL
        # mesh (graphs.use_graphs).
        self.graphed = graphed
        self._graphs = None

    @classmethod
    def from_run_dir(cls, run_dir: str, image_shape, *, dtype=None,
                     device=None, **kw) -> "Predictor":
        """Rebuild the model of a training run: flags from
        ``<run>/options.toml``, parameters from ``<run>/../<name>.npy``,
        for inputs of ``image_shape`` = (H, W, C)."""
        with open(os.path.join(run_dir, 'options.toml'), 'rb') as f:
            opts = tomllib.load(f)
        snap = os.path.join(os.path.dirname(run_dir.rstrip('/')),
                            opts['name'] + '.npy')
        _, loaded = checkpoint.load_layer_parameters(
            snap, len(parse_ints(opts['M'])))
        model = build_model(types.SimpleNamespace(**opts), image_shape,
                            loaded, dtype=dtype, device=device)
        prep_path = os.path.join(run_dir, 'preprocessing.npz')
        if 'preprocessing' not in kw and os.path.exists(prep_path):
            with np.load(prep_path) as d:
                kw['preprocessing'] = {'mean': d['mean'], 'scale': d['scale']}
        return cls(model, device=device, **kw)

    def _generator(self) -> torch.Generator:
        """The draw stream of the next batch: seeded from ``seed`` and the
        number of batches served so far."""
        self._calls += 1
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed << 32) + self._calls)
        return g

    def _serve(self, kind: str, fn, flat, Y=None) -> list:
        """``fn(xb, yb, generator)`` over the request's padded batches;
        returns each batch's result gathered over the data ranks and cut
        to its true rows.  Graphed, the batch is copied into the graph of
        (``kind``, its shape, the mesh), whose generator is seeded as
        :meth:`_generator` seeds the eager one."""
        outs = []
        with sharding.mesh_context(self.mesh):
            if not graphs.use_graphs(self.graphed, self.device,
                                     f'Predictor.{kind}'):
                for _, n, xb, yb in self._batches(flat, Y):
                    with profiling.annotate('serve batch', device=True):
                        out = fn(xb, yb, self._generator())
                        outs.append(sharding.gather_rows(out)[:n])
                return outs
            if self._graphs is None:
                self._graphs = graphs.GraphCache(self.device)
            g = self._graphs.generator(kind)
            with profiling.annotate('serve key'):
                ident = graphs.tensor_key(graphs.module_tensors(self.model))
            for _, n, xb, yb in self._batches(flat, Y):
                self._calls += 1
                g.manual_seed((self.seed << 32) + self._calls)
                key = (kind, tuple(xb.shape), self.num_samples,
                       graphs.mesh_key(), ident)
                out = self._graphs.run(
                    key, lambda x, y: sharding.gather_rows(fn(x, y, g)),
                    (xb, yb), (g,), request=self._requests)
                with profiling.annotate('serve finish', device=True):
                    outs.append(out[:n].clone())
        return outs

    def _request(self, kind: str, fn, X, raw: bool, Y=None, width=()):
        """One request, a span of its own: ``fn`` over the prepared rows'
        batches (:meth:`_serve`), then the wait for the card and the
        answers gathered on the host as float32 [N, *width]."""
        self._requests += 1
        with profiling.annotate(kind, request=self._requests):
            with profiling.annotate('serve prepare'):
                flat = self._prepare(X, raw)
                if Y is not None:
                    Y = np.asarray(Y).reshape(-1, 1)
                    if Y.shape[0] != flat.shape[0]:
                        raise ValueError(f'X has {flat.shape[0]} rows but Y '
                                         f'has {Y.shape[0]} labels')
                    Y = Y.astype(np.int64)
            outs = self._serve(kind, fn, flat, Y)
            with profiling.annotate('serve wait'):
                self._sync()
            with profiling.annotate('serve finish', device=True):
                if not outs:
                    return np.empty((0, *width), np.float32)
                return torch.cat(outs).cpu().numpy().astype(np.float32)

    def _prepare(self, X, raw: bool) -> np.ndarray:
        """Flatten, and standardize raw inputs with the training scaler."""
        X = np.asarray(X)
        flat = X.reshape(X.shape[0], -1)
        if raw:
            if self.preprocessing is None:
                raise ValueError(
                    'raw=True requires preprocessing statistics (train with '
                    'the Experiment CLI, which persists preprocessing.npz)')
            flat = ((flat - self.preprocessing['mean'])
                    / self.preprocessing['scale']).astype(np.float32)
        return flat

    def _batches(self, flat: np.ndarray, Y: np.ndarray | None = None):
        """(start, rows, batch, labels) over the request padded to whole
        batches (``multihost.pad_rows``), moved to the device in one
        transfer; under a mesh, this data rank's rows of each batch."""
        N = flat.shape[0]
        B = self.batch_size
        with profiling.annotate('serve h2d', device=True):
            if Y is None:
                Y = np.zeros((N, 1), np.int64)
            flat, Y = multihost.pad_rows(flat, Y, B)
            Xd = torch.as_tensor(flat).to(self.device, self.dtype)
            Yd = torch.as_tensor(Y).to(self.device)
        rows = slice(None) if self.mesh is None else self.mesh.rows(B)
        for start in range(0, N, B):
            yield (start, min(B, N - start), Xd[start:start + B][rows],
                   Yd[start:start + B][rows])

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def predict_proba(self, X, raw: bool = False) -> np.ndarray:
        """[N, D or H, W, C] -> [N, K] mean class probabilities."""
        return self._request('predict_proba', lambda xb, _, g: (
            self.model.predict_y(xb, self.num_samples, generator=g)[0]
            .mean(0)), X, raw, width=(self.model.likelihood.num_classes,))

    def predict(self, X, raw: bool = False) -> np.ndarray:
        """[N, ...] -> [N] argmax class labels."""
        return self.predict_proba(X, raw=raw).argmax(axis=1)

    def log_density(self, X, Y, raw: bool = False) -> np.ndarray:
        """Per-point predictive log p(y | x), [N]."""
        # The padding rows' sentinel -1 read as class 0: their densities
        # are dropped.
        return self._request('log_density', lambda xb, yb, g: (
            self.model.predict_density(xb, yb.clamp_min(0), self.num_samples,
                                       generator=g)[:, 0]), X, raw, Y=Y)
