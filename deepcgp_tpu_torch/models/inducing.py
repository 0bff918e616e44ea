"""Inducing-feature initialisation (counterpart of
``deepcgp_tpu/models/inducing.py``): for patch features 100 M random
patches, one from a random training image each, then k-means with M
clusters; for the inducing points of a plain-RBF last layer k-means with
k-means++ seeding over the data rows."""

from __future__ import annotations

import numpy as np
import torch

from deepcgp_tpu_torch import native
from deepcgp_tpu_torch.ops.kmeans import kmeans

SAMPLES_PER_INDUCING_POINT = 100


def gather_patches(NHWC: np.ndarray, img, ys, xs, f: int) -> np.ndarray:
    """The f x f patches at the given (image, y, x) offsets, TF element
    order, [count, f*f*C]: gathered by the native data path for float32
    images (the JAX package's ``native.sample_patches``), by its numpy
    version for the float64 images of the CPU tests."""
    if np.asarray(NHWC).dtype == np.float32:
        return native.sample_patches(NHWC, img, ys, xs, f)
    return native.sample_patches_numpy(NHWC, img, ys, xs, f)


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
