"""K-means (Lloyd) on the model's device (counterpart of
``deepcgp_tpu/ops/kmeans.py``): random initial centers for the inducing
patches, k-means++ for the inducing points of a plain-RBF last layer."""

from __future__ import annotations

import torch

from deepcgp_tpu_torch.ops.distances import square_distance


def _plusplus_init(X: torch.Tensor, k: int,
                   generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding: the first center a uniform row of X, each next
    one a row drawn with probability proportional to its squared distance
    to the nearest center so far (a row already chosen has distance 0 and
    is never drawn again).  The draws are uniforms from ``generator``
    inverted through the distances' running sum, on X's device, with no
    host sync."""
    N = X.shape[0]
    gdev = generator.device
    first = torch.randint(0, N, (1,), generator=generator, device=gdev).to(X.device)
    u = torch.rand(k - 1, generator=generator, device=gdev,
                   dtype=X.dtype).to(X.device)
    centers = X.new_empty(k, X.shape[1])
    c = X[first]                                            # [1, D]
    centers[0] = c[0]
    d2 = (X - c).square().sum(1)
    for i in range(1, k):
        cdf = torch.cumsum(d2, 0)
        idx = torch.searchsorted(cdf, (u[i - 1] * cdf[-1]).reshape(1),
                                 right=True).clamp_max(N - 1)
        c = X[idx]
        centers[i] = c[0]
        d2 = torch.minimum(d2, (X - c).square().sum(1))
    return centers


@torch.no_grad()
def kmeans(X: torch.Tensor, k: int, iters: int = 50, *,
           centers: torch.Tensor | None = None,
           generator: torch.Generator | None = None,
           init: str = 'random') -> torch.Tensor:
    """Cluster rows of X [N, D] into k centers [k, D].  The initial
    centers are ``centers``, else drawn with ``generator``: k distinct
    rows of X (``init='random'``) or k-means++ seeding
    (``init='k-means++'``).  Each iteration assigns rows to their nearest
    center (first index on a tie) and moves every non-empty cluster's
    center to its mean; an empty cluster keeps its center."""
    N = X.shape[0]
    if centers is None:
        if generator is None:
            raise ValueError('kmeans: pass centers or a generator')
        if init == 'random':
            idx = torch.randperm(N, generator=generator,
                                 device=generator.device)[:k].to(X.device)
            centers = X[idx]
        elif init == 'k-means++':
            centers = _plusplus_init(X, k, generator)
        else:
            raise ValueError(f'kmeans: unknown init {init!r}')
    centers = centers.to(X.dtype)
    for _ in range(iters):
        assign = square_distance(X, centers).argmin(dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype)  # [N, k]
        counts = onehot.sum(0)
        new = (onehot.T @ X) / counts.clamp_min(1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new, centers)
    return centers
