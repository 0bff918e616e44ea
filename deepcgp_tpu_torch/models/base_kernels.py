"""Base (patch-space) kernels (counterpart of
``deepcgp_tpu/models/base_kernels.py``; ``ArcCosine`` is not ported yet)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deepcgp_tpu_torch.ops.distances import square_distance
from deepcgp_tpu_torch.utils.transforms import positive_backward, positive_forward


def frozen_parameter(value: torch.Tensor) -> nn.Parameter:
    """A trainable leaf, created without ``requires_grad``: prediction
    builds no autograd graph, and ``training.trainer.init_state`` switches
    gradients on for the parameters it trains."""
    return nn.Parameter(torch.as_tensor(value).detach(), requires_grad=False)


class RBF(nn.Module):
    """k(x, x') = variance * exp(-||x - x'||^2 / (2 lengthscales^2)).

    Holds raw (Log1pe-inverse) parameters; ``raw_lengthscales`` is a scalar
    for an isotropic kernel or [D] for ARD."""

    def __init__(self, raw_variance: torch.Tensor, raw_lengthscales: torch.Tensor):
        super().__init__()
        self.raw_variance = frozen_parameter(raw_variance)
        self.raw_lengthscales = frozen_parameter(raw_lengthscales)

    @classmethod
    def create(cls, variance=5.0, lengthscales=5.0, *, ard_dim: int | None = None,
               dtype=torch.float32, device=None) -> "RBF":
        ls = np.asarray(lengthscales, dtype=np.float64)
        if ard_dim is not None and ls.ndim == 0:
            ls = np.full((ard_dim,), float(ls))
        return cls(
            torch.as_tensor(positive_backward(variance), dtype=dtype, device=device),
            torch.as_tensor(positive_backward(ls), dtype=dtype, device=device))

    @property
    def variance(self) -> torch.Tensor:
        return positive_forward(self.raw_variance)

    @property
    def lengthscales(self) -> torch.Tensor:
        return positive_forward(self.raw_lengthscales)

    def K(self, X: torch.Tensor, X2: torch.Tensor | None = None) -> torch.Tensor:
        ls = self.lengthscales
        if ls.ndim == 0:
            # Isotropic: scale the squared distance, not the inputs.
            d2 = square_distance(X, X2)
            return self.variance * torch.exp((-0.5 / ls.square()) * d2)
        X2l = None if X2 is None else X2 / ls
        return self.variance * torch.exp(-0.5 * square_distance(X / ls, X2l))

    def Kdiag(self, X: torch.Tensor) -> torch.Tensor:
        return self.variance.expand(X.shape[:-1]).to(X.dtype)
