"""K-means (Lloyd) on the model's device (counterpart of
``deepcgp_tpu/ops/kmeans.py``, its random-init form: the one the
inducing-patch initialisation uses)."""

from __future__ import annotations

import torch

from deepcgp_tpu_torch.ops.distances import square_distance


@torch.no_grad()
def kmeans(X: torch.Tensor, k: int, iters: int = 50, *,
           centers: torch.Tensor | None = None,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """Cluster rows of X [N, D] into k centers [k, D].  The initial
    centers are ``centers``, else k distinct rows of X drawn with
    ``generator``.  Each iteration assigns rows to their nearest center
    (first index on a tie) and moves every non-empty cluster's center to
    its mean; an empty cluster keeps its center."""
    N = X.shape[0]
    if centers is None:
        if generator is None:
            raise ValueError('kmeans: pass centers or a generator')
        idx = torch.randperm(N, generator=generator,
                             device=generator.device)[:k].to(X.device)
        centers = X[idx]
    centers = centers.to(X.dtype)
    for _ in range(iters):
        assign = square_distance(X, centers).argmin(dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype)  # [N, k]
        counts = onehot.sum(0)
        new = (onehot.T @ X) / counts.clamp_min(1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new, centers)
    return centers
