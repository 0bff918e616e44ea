"""Inference / serving layer (counterpart of ``deepcgp_tpu/serving.py``,
single card; the mesh is not ported yet).

``Predictor`` serves class probabilities, labels and predictive
log-densities from a model loaded from a reference-format snapshot plus the
flags recorded in the run's ``options.toml``.  Requests are padded to whole
batches and move to the card in one transfer; every batch is enqueued
before one ``torch.cuda.synchronize()`` per request.  Monte-Carlo draws
come from a ``torch.Generator`` seeded from ``seed`` and the batch count,
so answers are reproducible for a given seed (the stream is not the JAX
package's).
"""

from __future__ import annotations

import os
import tomllib
import types

import numpy as np
import torch

from deepcgp_tpu_torch import config
from deepcgp_tpu_torch.models.builder import build_model, parse_ints
from deepcgp_tpu_torch.utils import checkpoint


class Predictor:
    """Batched, pad-to-shape prediction server."""

    def __init__(self, model, *, batch_size: int = 32, num_samples: int = 5,
                 seed: int = 0, preprocessing: dict | None = None,
                 device=None):
        self.device = config.default_device(device)
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

    def _batches(self, flat: np.ndarray):
        """(start, rows, batch) over the request padded to whole batches,
        moved to the device in one transfer."""
        N = flat.shape[0]
        B = self.batch_size
        pad = (-N) % B
        if pad:
            flat = np.concatenate([flat, np.zeros((pad,) + flat.shape[1:],
                                                  flat.dtype)])
        Xd = torch.as_tensor(flat).to(self.device, self.dtype)
        for start in range(0, N, B):
            yield start, min(B, N - start), Xd[start:start + B]

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def predict_proba(self, X, raw: bool = False) -> np.ndarray:
        """[N, D or H, W, C] -> [N, K] mean class probabilities."""
        flat = self._prepare(X, raw)
        outs = []
        for _, n, xb in self._batches(flat):
            probs, _ = self.model.predict_y(xb, self.num_samples,
                                            generator=self._generator())
            outs.append(probs.mean(0)[:n])
        self._sync()
        if not outs:
            return np.empty((0, self.model.likelihood.num_classes), np.float32)
        return torch.cat(outs).cpu().numpy().astype(np.float32)

    def predict(self, X, raw: bool = False) -> np.ndarray:
        """[N, ...] -> [N] argmax class labels."""
        return self.predict_proba(X, raw=raw).argmax(axis=1)

    def log_density(self, X, Y, raw: bool = False) -> np.ndarray:
        """Per-point predictive log p(y | x), [N]."""
        flat = self._prepare(X, raw)
        Y = np.asarray(Y).reshape(-1, 1)
        if Y.shape[0] != flat.shape[0]:
            raise ValueError(f'X has {flat.shape[0]} rows but Y has '
                             f'{Y.shape[0]} labels')
        outs = []
        for start, n, xb in self._batches(flat):
            yb = np.zeros((xb.shape[0], 1), np.int64)
            yb[:n] = Y[start:start + n]
            dens = self.model.predict_density(
                xb, torch.as_tensor(yb, device=self.device), self.num_samples,
                generator=self._generator())
            outs.append(dens[:n, 0])
        self._sync()
        if not outs:
            return np.empty((0,), np.float32)
        return torch.cat(outs).cpu().numpy().astype(np.float32)
