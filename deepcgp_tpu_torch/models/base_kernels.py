"""Base (patch-space) kernels: RBF and ArcCosine (counterpart of
``deepcgp_tpu/models/base_kernels.py``)."""

from __future__ import annotations

import math

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


class ArcCosine(nn.Module):
    """gpflow 1.x ArcCosine kernel of order 0, 1 or 2 (``--base-kernel
    acos`` builds order 0):
    K(x, y) = variance / pi * J(theta) * ||x||^order ||y||^order, with the
    weighted product <x, y> = sum_d w_d x_d y_d + bias_variance.

    Holds raw (Log1pe-inverse) parameters; ``raw_weight_variances`` is a
    scalar or [D] for ARD."""

    def __init__(self, raw_variance: torch.Tensor,
                 raw_weight_variances: torch.Tensor,
                 raw_bias_variance: torch.Tensor, order: int = 0):
        super().__init__()
        if order not in (0, 1, 2):
            raise ValueError(f'ArcCosine: order {order} is not 0, 1 or 2')
        self.raw_variance = frozen_parameter(raw_variance)
        self.raw_weight_variances = frozen_parameter(raw_weight_variances)
        self.raw_bias_variance = frozen_parameter(raw_bias_variance)
        self.order = order

    @classmethod
    def create(cls, variance=1.0, weight_variances=1.0, bias_variance=1.0, *,
               order: int = 0, ard_dim: int | None = None,
               dtype=torch.float32, device=None) -> "ArcCosine":
        wv = np.asarray(weight_variances, dtype=np.float64)
        if ard_dim is not None and wv.ndim == 0:
            wv = np.full((ard_dim,), float(wv))
        kw = dict(dtype=dtype, device=device)
        return cls(torch.as_tensor(positive_backward(variance), **kw),
                   torch.as_tensor(positive_backward(wv), **kw),
                   torch.as_tensor(positive_backward(bias_variance), **kw),
                   order)

    @property
    def variance(self) -> torch.Tensor:
        return positive_forward(self.raw_variance)

    @property
    def weight_variances(self) -> torch.Tensor:
        return positive_forward(self.raw_weight_variances)

    @property
    def bias_variance(self) -> torch.Tensor:
        return positive_forward(self.raw_bias_variance)

    def _weighted_product(self, X, X2=None):
        # w * X first, as the JAX package does: on the self-gram's diagonal
        # arccos is evaluated at its clip, where its derivative magnifies
        # the last bit of cos(theta).
        w = self.weight_variances
        if X2 is None:
            return torch.sum(w * X.square(), dim=-1) + self.bias_variance
        return torch.matmul(w * X, X2.transpose(-1, -2)) + self.bias_variance

    def _J(self, theta):
        if self.order == 0:
            return math.pi - theta
        if self.order == 1:
            return torch.sin(theta) + (math.pi - theta) * torch.cos(theta)
        c = torch.cos(theta)
        return 3.0 * torch.sin(theta) * c + (math.pi - theta) * (1.0 + 2.0 * c ** 2)

    def K(self, X: torch.Tensor, X2: torch.Tensor | None = None) -> torch.Tensor:
        denom_X = torch.sqrt(self._weighted_product(X))
        if X2 is None:
            numerator = self._weighted_product(X, X)
            denom_X2 = denom_X
        else:
            numerator = self._weighted_product(X, X2)
            denom_X2 = torch.sqrt(self._weighted_product(X2))
        cos_theta = numerator / denom_X[..., :, None] / denom_X2[..., None, :]
        # gpflow squeezes cos(theta) by 1e-15 before arccos, a float64 guard
        # that rounds away in float32 and leaves arccos'(1) = inf on the
        # self-gram's diagonal: the squeeze is scaled to the dtype.
        eps = 1e-15 if cos_theta.dtype == torch.float64 else 1e-6
        theta = torch.arccos(torch.clamp(eps + (1.0 - 2.0 * eps) * cos_theta,
                                         -1.0, 1.0))
        scale = (denom_X[..., :, None] ** self.order
                 * denom_X2[..., None, :] ** self.order)
        return self.variance * (1.0 / math.pi) * self._J(theta) * scale

    def Kdiag(self, X: torch.Tensor) -> torch.Tensor:
        prod = self._weighted_product(X)
        J0 = self._J(prod.new_zeros(()))
        return self.variance * (1.0 / math.pi) * J0 * prod ** self.order
