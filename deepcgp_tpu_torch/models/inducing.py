"""Inducing-feature initialisation (counterpart of
``deepcgp_tpu/models/inducing.py``): for patch features 100 M random
patches, one from a random training image each, then k-means with M
clusters; for the inducing points of a plain-RBF last layer k-means with
k-means++ seeding over the data rows."""

from __future__ import annotations

import numpy as np
import torch

from deepcgp_tpu_torch.ops.kmeans import kmeans

SAMPLES_PER_INDUCING_POINT = 100


def gather_patches(NHWC: np.ndarray, img, ys, xs, f: int) -> np.ndarray:
    """The f x f patches at the given (image, y, x) offsets, TF element
    order, [count, f*f*C] (the port's copy of the numpy form of the JAX
    package's ``native.sample_patches``)."""
    n, hh, ww, c = NHWC.shape
    img, ys, xs = np.asarray(img), np.asarray(ys), np.asarray(xs)
    if len(img) and not ((0 <= img.min() and img.max() < n)
                         and (0 <= ys.min() and ys.max() <= hh - f)
                         and (0 <= xs.min() and xs.max() <= ww - f)):
        raise IndexError('gather_patches offsets out of range')
    win = np.lib.stride_tricks.sliding_window_view(NHWC, (f, f), axis=(1, 2))
    patches = win[img, ys, xs]                    # [count, C, f, f]
    return np.moveaxis(patches, 1, -1).reshape(len(img), -1)


def sample_patches(NHWC: np.ndarray, count: int, patch_size: int,
                   generator: torch.Generator) -> np.ndarray:
    """``count`` random patches, one from a random image each; offsets are
    drawn from [0, size - patch_size), the reference's exclusive range."""
    N, H, W, _ = NHWC.shape

    def draw(high):
        return torch.randint(0, high, (count,), generator=generator,
                             device=generator.device).cpu().numpy()
    img, ys, xs = draw(N), draw(H - patch_size), draw(W - patch_size)
    return gather_patches(NHWC, img, ys, xs, patch_size)


def patch_inducing_points(NHWC: np.ndarray, M: int, patch_size: int, *,
                          generator: torch.Generator, dtype=torch.float32,
                          device=None, kmeans_iters: int = 50) -> torch.Tensor:
    """[M, patch_size^2 * C] initial inducing patches: k-means of sampled
    patches, clustered on ``device``."""
    patches = sample_patches(NHWC, M * SAMPLES_PER_INDUCING_POINT,
                             patch_size, generator)
    X = torch.as_tensor(patches, dtype=dtype, device=device)
    return kmeans(X, M, kmeans_iters, generator=generator)


def inducing_points_from_data(X: np.ndarray, M: int, *,
                              generator: torch.Generator, dtype=torch.float32,
                              device=None, kmeans_iters: int = 50) -> torch.Tensor:
    """[M, D] initial inducing points of a plain-RBF last layer: k-means
    with k-means++ seeding over the (flattened) data rows X [N, D],
    clustered on ``device``."""
    X = torch.as_tensor(np.asarray(X), dtype=dtype, device=device)
    return kmeans(X, M, kmeans_iters, generator=generator, init='k-means++')
