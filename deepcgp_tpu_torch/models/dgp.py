"""Doubly-stochastic deep GP (counterpart of ``deepcgp_tpu/models/dgp.py``).

The Kuu factorizations are computed once per call and shared by the S
Monte-Carlo samples; the first layer's conditional depends only on X, so it
is evaluated once and sampled S times; later layers fold the S sample paths
into the batch.  Sampling noise comes from an explicit ``torch.Generator``,
or is handed in whole (the parity tests replay the JAX package's draws).
Prediction runs without autograd; ``elbo`` is differentiable.
"""

from __future__ import annotations

import math
import typing

import torch
from torch import nn

from deepcgp_tpu_torch.config import JITTER
from deepcgp_tpu_torch.ops import linalg
from deepcgp_tpu_torch.parallel import sharding


class PropagateResult(typing.NamedTuple):
    samples: list    # per layer: [S, N, O_l]
    means: list
    variances: list


class DGP(nn.Module):
    """A stack of layers and a likelihood.  ``num_data`` is the training
    set's size (the minibatch ELBO's scale), ``num_samples`` the S of the
    training ELBO."""

    def __init__(self, layers, likelihood, num_data: int = 0,
                 num_samples: int = 10):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.likelihood = likelihood
        self.num_data = num_data
        self.num_samples = num_samples

    def precompute(self) -> tuple:
        """Per-layer caches; all same-shape Kuu grams of the stack (the
        conditionals' and the frozen KL priors') are factorized, with their
        inverses, in one batched call per distinct shape."""
        grams = [layer.kuu_grams() for layer in self.layers]
        flat = [g for gs in grams for g in gs]
        pairs: list = [None] * len(flat)
        by_shape: dict = {}
        for i, g in enumerate(flat):
            by_shape.setdefault(tuple(g.shape), []).append(i)
        for idxs in by_shape.values():
            Lb, Lib = linalg.chol_with_inv(torch.stack([flat[i] for i in idxs]))
            for k, i in enumerate(idxs):
                pairs[i] = (Lb[k], Lib[k])
        caches, pos = [], 0
        for layer, gs in zip(self.layers, grams):
            caches.append(layer.make_cache(tuple(pairs[pos:pos + len(gs)])))
            pos += len(gs)
        return tuple(caches)

    def propagate(self, X: torch.Tensor, S: int, *,
                  generator: torch.Generator | None = None,
                  noise: list | None = None, caches=None) -> PropagateResult:
        """Draw S sample paths through the stack; X [N, D].  The standard
        normals come from ``noise`` (one [S, N, O_l] tensor per layer) when
        given, else from ``generator``.  Under a data axis X holds this
        rank's rows of the global batch, ``noise`` the global batch's
        draws, and a draw from ``generator`` is the global batch's: each
        rank keeps its rows, so the noise is the single-process one."""
        if (noise is None) == (generator is None):
            raise ValueError('propagate: pass exactly one of generator, noise')
        if caches is None:
            caches = self.precompute()
        samples, means, variances = [], [], []
        F = None
        for i, (layer, cache) in enumerate(zip(self.layers, caches)):
            if F is None:
                mean, var = layer.conditional_mean_var(cache, X)
                mean = mean.expand(S, *mean.shape)
                var = var.expand(S, *var.shape)
            else:
                S_, N_, O_ = F.shape
                mean, var = layer.conditional_mean_var(
                    cache, F.reshape(S_ * N_, O_))
                mean = mean.reshape(S_, N_, -1)
                var = var.reshape(S_, N_, -1)
            if noise is not None:
                z = torch.as_tensor(noise[i], dtype=mean.dtype, device=mean.device)
                if z.shape != mean.shape:
                    z = sharding.own_rows(z, dim=1)
                if z.shape != mean.shape:
                    raise ValueError(f'noise[{i}] is {tuple(z.shape)}, '
                                     f'layer {i} draws {tuple(mean.shape)}')
            else:
                z = sharding.normal(mean.shape, generator, dtype=mean.dtype,
                                    device=mean.device, dim=1)
            F = mean + z * torch.sqrt(var + JITTER)
            samples.append(F)
            means.append(mean)
            variances.append(var)
        return PropagateResult(samples, means, variances)

    # -- training ------------------------------------------------------------
    def expected_log_likelihood(self, X: torch.Tensor, Y: torch.Tensor,
                                caches=None, **draw) -> torch.Tensor:
        """Monte-Carlo E_q[log p(y | f_L)] over ``num_samples`` paths,
        summed over the batch.  ``draw``: ``generator=`` or ``noise=``."""
        S = self.num_samples
        res = self.propagate(X, S, caches=caches, **draw)
        Yb = Y.expand(S, *Y.shape)
        ve = self.likelihood.variational_expectations(
            res.means[-1], res.variances[-1], Yb)
        return ve.mean(0).sum()

    def prior_kl(self, caches=None) -> torch.Tensor:
        if caches is None:
            caches = (None,) * len(self.layers)
        return sum(layer.KL(cache)
                   for layer, cache in zip(self.layers, caches))

    def elbo(self, X: torch.Tensor, Y: torch.Tensor, **draw) -> torch.Tensor:
        """Minibatch ELBO: num_data / batch * E_q[log p(y | f)] - sum KL.
        Under a data axis of size n, X holds this rank's rows of the global
        batch and the result is this rank's share: the batch is the global
        one (n times X's rows) and the KL enters divided by n, so the
        shares sum to the ELBO."""
        caches = self.precompute()
        n = sharding.data_size()
        scale = self.num_data / (X.shape[0] * n)
        return scale * self.expected_log_likelihood(X, Y, caches, **draw) \
            - self.prior_kl(caches) / n

    def compute_log_likelihood(self, X: torch.Tensor, Y: torch.Tensor,
                               **draw) -> torch.Tensor:
        """The minibatch ELBO, by the reference's name for it."""
        return self.elbo(X, Y, **draw)

    # -- prediction ----------------------------------------------------------
    @torch.no_grad()
    def predict_y(self, X: torch.Tensor, S: int, **draw):
        """Per-sample predictive class probabilities and their variances,
        ([S, N, K], [S, N, K]).  ``draw``: ``generator=`` or ``noise=``."""
        res = self.propagate(X, S, **draw)
        return self.likelihood.predict_mean_and_var(res.means[-1],
                                                    res.variances[-1])

    @torch.no_grad()
    def predict_density(self, X: torch.Tensor, Y: torch.Tensor, S: int,
                        **draw) -> torch.Tensor:
        """Per-point log E_S[p(y | f_L)], [N, 1]."""
        res = self.propagate(X, S, **draw)
        Yb = Y.expand(S, *Y.shape)
        logp = self.likelihood.predict_density(res.means[-1],
                                               res.variances[-1], Yb)
        return torch.logsumexp(logp, dim=0) - math.log(S)
