"""TensorBoard observability (counterpart of
``deepcgp_tpu/utils/tensorboard.py``), written through the port's own
event writer (:mod:`deepcgp_tpu_torch.utils.events`).

Tasks, with the JAX package's tags:

* ``LogLikelihoodLogger`` -- 'train_log_likelihood', the minibatch ELBO
  per point over the first min(5000, N) training rows in batches of 64;
* ``ModelParameterLogger`` -- a scalar or a histogram of every leaf the
  JAX model holds, tagged as the JAX logger tags it
  ('model.layers[0].base_kernel.raw_variance', 'model.layers[0].Z0', ...,
  stored cleaned as 'model.layers_0_.Z0', as tensorboardX stores them);
* ``LayerOutputLogger`` -- 'conv_sample', 'conv_mean' and 'conv_var',
  one test image's layer-0 samples, mean and variance as grey grids;
* ``PatchCovarianceLogger`` -- 'Kuf_covariance' of one training image.

Each entry's Monte-Carlo noise comes from a generator seeded with the
step, so an entry is reproducible; a logger's ``draw`` hands the noise
over and can be replaced to replay other draws.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from deepcgp_tpu_torch.models.layers import ConvLayer
from deepcgp_tpu_torch.training.optim import jax_keystr, jax_leaf_order
from deepcgp_tpu_torch.utils.events import EventWriter


def _step_index(step: int, n: int) -> int:
    """A row index derived from the step (Knuth multiplicative hash), the
    JAX package's choice of image for an entry."""
    return (int(step) * 2654435761) % max(int(n), 1)


def _generator(step: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(step))
    return g


class LogLikelihoodLogger:
    title = 'train_log_likelihood'

    def __init__(self, batch_size: int = 64, compute_on: int = 5000):
        self.batch_size = batch_size
        self.compute_on = compute_on

    def draw(self, generator, step: int, batch: int, model, rows: int) -> dict:
        """The ELBO's draw for batch ``batch`` of the entry at ``step``."""
        return {'generator': generator}

    @torch.no_grad()
    def __call__(self, writer, experiment, step):
        model = experiment.model
        X, Y = experiment.X_train_dev, experiment.Y_train_dev
        n = min(self.compute_on, X.shape[0])
        batches = math.ceil(n / self.batch_size)
        g = _generator(step, X.device)
        total = X.new_zeros(())
        for i in range(batches):
            xb = X[i * self.batch_size:(i + 1) * self.batch_size]
            yb = Y[i * self.batch_size:(i + 1) * self.batch_size]
            total += model.elbo(xb, yb,
                                **self.draw(g, step, i, model, xb.shape[0]))
        writer.add_scalar(self.title,
                          float(total) / (batches * self.batch_size), step)


class ModelParameterLogger:
    """Every leaf of the JAX model, in its order: a scalar for a single
    value, else a histogram."""

    def __call__(self, writer, experiment, step):
        for name, t in jax_leaf_order(experiment.model):
            arr = t.detach().cpu().numpy()
            tag = 'model' + jax_keystr(name)
            if arr.size == 1:
                writer.add_scalar(tag, float(arr.reshape(())), step)
            else:
                writer.add_histogram(tag, arr.reshape(-1), step)


class LayerOutputLogger:
    """One test image's layer-0 samples, mean and variance maps."""

    def __init__(self, num_samples: int = 4):
        self.num_samples = num_samples

    def noise(self, step: int, shape, like: torch.Tensor) -> torch.Tensor:
        """The samples' standard normals, [num_samples, 1, O]."""
        return torch.randn(shape, generator=_generator(step, like.device),
                           dtype=like.dtype, device=like.device)

    @torch.no_grad()
    def __call__(self, writer, experiment, step):
        layer = experiment.model.layers[0]
        if not isinstance(layer, ConvLayer):
            return
        X = experiment.X_test_dev
        idx = _step_index(step, X.shape[0])
        mean, var = layer.conditional_mean_var(layer.precompute(),
                                               X[idx:idx + 1])
        z = self.noise(step, (self.num_samples,) + tuple(mean.shape), mean)
        samples = (mean[None] + z * torch.sqrt(var[None] + 1e-6)).cpu().numpy()
        fm = layer.gp_count
        hw = layer.view.out_image_height, layer.view.out_image_width
        writer.add_image('conv_sample', _grid_image(samples[:, 0], hw, fm),
                         step)
        writer.add_image('conv_mean', _grid_image(mean.cpu().numpy(), hw, fm),
                         step)
        writer.add_image('conv_var', _grid_image(var.cpu().numpy(), hw, fm),
                         step)


class PatchCovarianceLogger:
    """Kuf [P, M] of one training image's patches against layer 0's Z."""

    @torch.no_grad()
    def __call__(self, writer, experiment, step):
        layer = experiment.model.layers[0]
        if not isinstance(layer, ConvLayer):
            return
        X = experiment.X_train_dev
        idx = _step_index(step, X.shape[0])
        H, W = layer.view.input_size
        img = X[idx:idx + 1].reshape(1, H, W, layer.view.feature_maps)
        PNL = layer.view.extract_patches_NPL(img).transpose(0, 1)
        Kuf = layer.conv_kernel.Kuf(layer.Z, PNL).cpu().numpy()  # [P, M, 1]
        writer.add_image('Kuf_covariance', _to_image(Kuf[:, :, 0]), step)


def _normalize(img: np.ndarray) -> np.ndarray:
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / (hi - lo + 1e-12)


def _to_image(arr2d: np.ndarray) -> np.ndarray:
    return _normalize(arr2d)[None, :, :]  # CHW, 1 channel


def _grid_image(rows: np.ndarray, hw, feature_maps: int) -> np.ndarray:
    """rows: [S, P*fm] patch-major -> tiled [1, S*h, fm*w] image, each map
    normalized to [0, 1] on its own."""
    rows = np.atleast_2d(rows)
    S = rows.shape[0]
    h, w = hw
    imgs = rows.reshape(S, h, w, feature_maps)
    tiled = np.concatenate(
        [np.concatenate([_normalize(imgs[s, :, :, f]) for f in
                         range(feature_maps)], axis=1) for s in range(S)],
        axis=0)
    return tiled[None]


class TensorBoardLog:
    """The tasks' events under ``<tensorboard_dir>/<name>``, flushed after
    every entry."""

    def __init__(self, tasks, tensorboard_dir: str, name: str):
        self.writer = EventWriter(os.path.join(tensorboard_dir, name))
        self.tasks = tasks

    def write_entry(self, experiment):
        step = experiment.global_step
        for task in self.tasks:
            task(self.writer, experiment, step)
        self.writer.flush()

    def close(self):
        self.writer.close()


def make_default_log(experiment) -> TensorBoardLog:
    tasks = [LogLikelihoodLogger(), ModelParameterLogger(),
             LayerOutputLogger()]
    return TensorBoardLog(tasks,
                          getattr(experiment.flags, 'tensorboard_dir',
                                  '/tmp/deepcgp/tensorboard'),
                          experiment.flags.name)
