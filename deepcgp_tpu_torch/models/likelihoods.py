"""Likelihoods (counterpart of ``deepcgp_tpu/models/likelihoods.py``):
the robust-max multiclass likelihood and an isotropic Gaussian.

Robust max: p(y = c | f) = 1 - eps if c = argmax(f), else eps / (K - 1).
The probability that a latent is the largest under a factorised Gaussian
q(f) is a 1-D Gauss-Hermite quadrature, as gpflow's ``RobustMax``
computes it.  The Gaussian's variance is a trained parameter, stored raw
as the kernels' positive parameters are.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from deepcgp_tpu_torch.config import NUM_GAUSS_HERMITE_POINTS
from deepcgp_tpu_torch.models.base_kernels import frozen_parameter
from deepcgp_tpu_torch.utils.transforms import positive_backward, positive_forward


# (n, dtype, device) -> the Gauss-Hermite points and weights: made once,
# so that no call copies them from the host (which a CUDA graph capture
# cannot hold).
_GH_POINTS: dict = {}


def _gh_points(n: int, like: torch.Tensor):
    key = (n, like.dtype, like.device)
    if key not in _GH_POINTS:
        x, w = np.polynomial.hermite.hermgauss(n)
        _GH_POINTS[key] = (
            torch.as_tensor(x, dtype=like.dtype, device=like.device),
            torch.as_tensor(w, dtype=like.dtype, device=like.device))
    return _GH_POINTS[key]


class _ProdOfNonzero(torch.autograd.Function):
    """``x.prod(dim)`` of factors that are never 0 (the clipped CDFs),
    with the backward autograd takes for ``prod`` when no factor is 0,
    grad * (prod / x), bit for bit, but without autograd's count of the
    zero factors: that count is read on the host, and a CUDA graph
    capture cannot hold a host sync."""

    @staticmethod
    def forward(ctx, x, dim):
        out = x.prod(dim)
        ctx.save_for_backward(x, out)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g.unsqueeze(ctx.dim) * (out.unsqueeze(ctx.dim) / x), None


def _cdf(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF with gpflow's clip into [1e-4, 1 - 1e-4]."""
    return (0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))) * (1.0 - 2e-4) + 1e-4


class MultiClass:
    """Robust-max likelihood over ``num_classes`` classes."""

    def __init__(self, num_classes: int = 10, epsilon: float = 1e-3,
                 num_gauss_hermite: int = NUM_GAUSS_HERMITE_POINTS):
        self.num_classes = num_classes
        self.epsilon = epsilon
        self.num_gauss_hermite = num_gauss_hermite

    @property
    def _eps_k1(self) -> float:
        return self.epsilon / (self.num_classes - 1.0)

    def prob_is_largest(self, Y: torch.Tensor, mu: torch.Tensor,
                        var: torch.Tensor) -> torch.Tensor:
        """P(f_{y_n} >= f_j for all j): Y [..., 1] int labels, mu, var
        [..., K] -> [..., 1]."""
        gh_x, gh_w = _gh_points(self.num_gauss_hermite, mu)
        # One-hot by comparison: F.one_hot on the CPU reads the labels'
        # range on the host.
        oh = (Y.long() == torch.arange(self.num_classes,
                                       device=Y.device)).to(mu.dtype)
        mu_sel = (oh * mu).sum(-1)
        var_sel = (oh * var).sum(-1)
        X = mu_sel[..., None] + gh_x * torch.sqrt(
            (2.0 * var_sel[..., None]).clamp_min(1e-10))      # [..., H]
        dist = (X[..., None, :] - mu[..., :, None]) / torch.sqrt(
            var[..., :, None].clamp_min(1e-10))                # [..., K, H]
        cdfs = _cdf(dist)
        cdfs = cdfs * (1.0 - oh[..., None]) + oh[..., None]
        p = (_ProdOfNonzero.apply(cdfs, -2) * gh_w).sum(-1) \
            / math.sqrt(math.pi)
        return p[..., None]

    def variational_expectations(self, Fmu: torch.Tensor, Fvar: torch.Tensor,
                                 Y: torch.Tensor) -> torch.Tensor:
        """E_q[log p(y | f)]: [..., 1]."""
        p = self.prob_is_largest(Y, Fmu, Fvar)
        return p * math.log(1.0 - self.epsilon) + \
            (1.0 - p) * math.log(self._eps_k1)

    def _prob_each_is_largest(self, mu: torch.Tensor, var: torch.Tensor):
        """P(f_c >= f_j for all j) for every class c at once: [..., K]."""
        gh_x, gh_w = _gh_points(self.num_gauss_hermite, mu)
        K = self.num_classes
        X = mu[..., :, None] + gh_x * torch.sqrt(
            (2.0 * var[..., :, None]).clamp_min(1e-10))       # [..., Kc, H]
        dist = (X[..., :, None, :] - mu[..., None, :, None]) / torch.sqrt(
            var[..., None, :, None].clamp_min(1e-10))          # [..., Kc, Kj, H]
        cdfs = _cdf(dist)
        eye = torch.eye(K, dtype=mu.dtype, device=mu.device)[..., None]
        cdfs = cdfs * (1.0 - eye) + eye
        return (cdfs.prod(-2) * gh_w).sum(-1) / math.sqrt(math.pi)

    def predict_mean_and_var(self, Fmu: torch.Tensor, Fvar: torch.Tensor):
        """Class probabilities p(y = c) and their Bernoulli variances."""
        p = self._prob_each_is_largest(Fmu, Fvar)
        mean = p * (1.0 - self.epsilon) + (1.0 - p) * self._eps_k1
        return mean, mean - mean.square()

    def predict_density(self, Fmu: torch.Tensor, Fvar: torch.Tensor,
                        Y: torch.Tensor) -> torch.Tensor:
        p = self.prob_is_largest(Y, Fmu, Fvar)
        return torch.log(p * (1.0 - self.epsilon) + (1.0 - p) * self._eps_k1)


class Gaussian(nn.Module):
    """Isotropic Gaussian likelihood, p(y | f) = N(y; f, variance), for
    regression with the DGP."""

    def __init__(self, raw_variance: torch.Tensor):
        super().__init__()
        self.raw_variance = frozen_parameter(raw_variance)

    @classmethod
    def create(cls, variance=1.0, dtype=torch.float32, device=None):
        return cls(torch.as_tensor(positive_backward(variance), dtype=dtype,
                                   device=device))

    @property
    def variance(self) -> torch.Tensor:
        return positive_forward(self.raw_variance)

    def variational_expectations(self, Fmu: torch.Tensor, Fvar: torch.Tensor,
                                 Y: torch.Tensor) -> torch.Tensor:
        """E_q[log N(y; f, variance)] summed over the outputs: [..., 1]."""
        v = self.variance
        ve = (-0.5 * math.log(2.0 * math.pi) - 0.5 * torch.log(v)
              - 0.5 * ((Y - Fmu).square() + Fvar) / v)
        return ve.sum(-1, keepdim=True)

    def predict_mean_and_var(self, Fmu: torch.Tensor, Fvar: torch.Tensor):
        return Fmu, Fvar + self.variance
