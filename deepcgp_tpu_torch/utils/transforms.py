"""Parameter bijectors (counterpart of ``deepcgp_tpu/utils/transforms.py``).

Positive parameters are stored raw through gpflow 1.x's ``Log1pe``
(softplus shifted by a small lower bound), so the constrained values of a
snapshot map to the same raw values the JAX package holds.
"""

from __future__ import annotations

import numpy as np
import torch

from deepcgp_tpu_torch.config import POSITIVE_MINIMUM


def positive_forward(unconstrained: torch.Tensor) -> torch.Tensor:
    """softplus(x) + lower (gpflow Log1pe.forward)."""
    return torch.logaddexp(unconstrained, torch.zeros_like(unconstrained)) \
        + POSITIVE_MINIMUM


def positive_backward(constrained) -> np.ndarray:
    """Inverse of :func:`positive_forward`, log(expm1(y - lower)), in
    float64 on the host."""
    y = np.asarray(constrained, dtype=np.float64) - POSITIVE_MINIMUM
    # log(e^y - 1) = y + log1p(-e^-y), stable for large y.
    return np.where(y > 20.0, y + np.log1p(-np.exp(-np.minimum(y, 30.0))),
                    np.log(np.expm1(np.maximum(y, 1e-10))))


def lower_triangular_flatten(mats: torch.Tensor) -> torch.Tensor:
    """[..., M, M] -> packed lower triangle [..., M(M+1)/2], row-major
    (gpflow's LowerTriangular storage order)."""
    M = mats.shape[-1]
    i, j = np.tril_indices(M)
    return mats[..., torch.as_tensor(i), torch.as_tensor(j)]


def lower_triangular_unflatten(packed: torch.Tensor, M: int) -> torch.Tensor:
    i, j = np.tril_indices(M)
    out = packed.new_zeros(packed.shape[:-1] + (M, M))
    out[..., torch.as_tensor(i), torch.as_tensor(j)] = packed
    return out
