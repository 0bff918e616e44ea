"""Pairwise squared distances (counterpart of ``deepcgp_tpu/ops/distances.py``)."""

from __future__ import annotations

import torch


def square_distance(X: torch.Tensor, X2: torch.Tensor | None = None) -> torch.Tensor:
    """||x_i - x2_j||^2 for rows of X [..., N, D] and X2 [..., N2, D], in the
    expanded form Xs - 2 X X2^T + X2s, clamped at zero against float32
    cancellation (``torch.maximum``, whose gradient at a tie splits in
    half, as JAX's does).

    A self-gram (X2 None) becomes a Kuu that is factorized, so its rows are
    centred first on their (gradient-free) mean: distances are
    translation-invariant, and centring shrinks the magnitudes entering the
    cancellation from ||x||^2 to ||x - mean||^2 -- the JAX package measured
    the uncentred float32 gram of a 3-layer CIFAR configuration going
    indefinite past the jitter.  Its product is ``linalg.gram_syrk``, whose
    backward is one product against the symmetrized cotangent."""
    from deepcgp_tpu_torch.ops.linalg import gram_syrk
    if X2 is None:
        Xc = X - X.mean(dim=-2, keepdim=True).detach()
        Xs = Xc.square().sum(-1)
        cross = gram_syrk(Xc)
        X2s = Xs
    else:
        Xs = X.square().sum(-1)
        cross = X @ X2.transpose(-1, -2)
        X2s = X2.square().sum(-1)
    d2 = Xs[..., :, None] - 2.0 * cross + X2s[..., None, :]
    return torch.maximum(d2, d2.new_zeros(()))
