"""Model inspection (counterpart of ``deepcgp_tpu/utils/inspect.py``): the
library form of the reference's analysis notebooks.

* ``layer_features`` -- per-layer samples, means and variances through
  ``DGP.propagate``;
* ``inducing_patches`` / ``inducing_patch_grid`` -- a layer's inducing
  patches as images, and tiled into one grey image;
* ``patch_embedding`` -- a 2-D embedding of inducing patches together with
  data patches (UMAP when importable, else joint PCA);
* ``noise_robustness`` -- test accuracy under additive Gaussian input
  noise.

Everything returns numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from deepcgp_tpu_torch.models.inducing import sample_patches
from deepcgp_tpu_torch.training import trainer


def _device_dtype(model):
    Z = model.layers[0].Z
    return Z.device, Z.dtype


@torch.no_grad()
def layer_features(model, X, num_samples: int = 1, **draw):
    """Per-layer (samples, means, variances) for flattened inputs X [N, D]:
    three lists of [S, N, O_l] arrays.  ``draw``: ``generator=`` or
    ``noise=``, as ``DGP.propagate`` takes them."""
    device, dtype = _device_dtype(model)
    X = torch.as_tensor(X, device=device, dtype=dtype)
    res = model.propagate(X, num_samples, **draw)

    def to_np(xs):
        return [x.cpu().numpy() for x in xs]
    return to_np(res.samples), to_np(res.means), to_np(res.variances)


def _view(layer):
    view = getattr(layer, 'view', None) or \
        getattr(getattr(layer, 'kernel', None), 'view', None)
    if view is None:
        raise ValueError("layer has no patch view (plain-RBF last layer)")
    return view


def inducing_patches(layer) -> np.ndarray:
    """A layer's inducing patches as [M, fh, fw, C] images."""
    Z = layer.Z.detach().cpu().numpy()
    view = _view(layer)
    f = view.filter_size
    return Z.reshape(Z.shape[0], f, f, view.feature_maps)


def inducing_patch_grid(layer, cols: int = 16, pad: int = 1) -> np.ndarray:
    """A layer's inducing patches (channel-averaged, normalized to
    [0, 1] together) tiled ``cols`` to a row into one [H, W] image."""
    patches = inducing_patches(layer).mean(axis=-1)  # [M, fh, fw]
    M, fh, fw = patches.shape
    rows = int(np.ceil(M / cols))
    lo, hi = patches.min(), patches.max()
    patches = (patches - lo) / (hi - lo + 1e-12)
    grid = np.zeros((rows * (fh + pad) - pad, cols * (fw + pad) - pad))
    for m in range(M):
        r, c = divmod(m, cols)
        grid[r * (fh + pad):r * (fh + pad) + fh,
             c * (fw + pad):c * (fw + pad) + fw] = patches[m]
    return grid


def _pca_2d(X: np.ndarray) -> np.ndarray:
    Xc = X - X.mean(axis=0)
    _, _, Vt = np.linalg.svd(Xc, full_matrices=False)
    return Xc @ Vt[:2].T


def patch_embedding(layer, NHWC_X: np.ndarray, max_data_patches: int = 5000,
                    seed: int = 0):
    """(emb_inducing [M, 2], emb_data [n, 2]): the layer's inducing
    patches embedded together with n = min(max_data_patches, 4 N) random
    data patches (drawn from a generator seeded with ``seed``): UMAP when
    ``umap`` is importable, else joint PCA."""
    view = _view(layer)
    Z = layer.Z.detach().cpu().numpy()
    NHWC_X = np.asarray(NHWC_X)
    data = sample_patches(NHWC_X, min(max_data_patches, NHWC_X.shape[0] * 4),
                          view.filter_size, torch.Generator().manual_seed(seed))
    joint = np.concatenate([Z, data], axis=0)
    try:
        import umap  # optional dependency (umap-learn)
        emb = umap.UMAP(n_components=2).fit_transform(joint)
    except ImportError:
        emb = _pca_2d(joint)
    return emb[:Z.shape[0]], emb[Z.shape[0]:]


def noise_robustness(model, X_test, Y_test, noise_levels=(0.0, 0.25, 0.5, 1.0),
                     batch_size: int = 32, num_samples: int = 5,
                     max_points: int = 512, seed: int = 0) -> dict:
    """{sigma: test accuracy} on the first ``max_points`` test points
    (arrays or tensors) with sigma times standard-normal noise added to the
    inputs.  The noise and
    each evaluation's draws come from generators on the model's device
    seeded from ``seed``."""
    device, dtype = _device_dtype(model)
    X = torch.as_tensor(X_test, device=device)
    X = X.reshape(X.shape[0], -1)[:max_points].to(dtype)
    Y = torch.as_tensor(Y_test, device=device).reshape(-1, 1)[:max_points]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = {}
    for i, sigma in enumerate(noise_levels):
        noise = torch.randn(X.shape, generator=g, dtype=dtype, device=device)
        out[float(sigma)] = trainer.accuracy(
            model, X + sigma * noise, Y, seed=seed + 1 + i,
            batch_size=batch_size, num_samples=num_samples)
    return out
