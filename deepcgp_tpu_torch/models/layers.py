"""GP layers: the hidden convolutional layer and the final SVGP layer
(counterpart of ``deepcgp_tpu/models/layers.py``, diagonal covariance
only).

Each layer exposes ``kuu_grams()`` (the [M, M] grams to factorize),
``make_cache(pairs)`` (a LayerCache from their (L, L^-1) pairs),
``conditional_mean_var(cache, ND_X)`` -> (mean [N, O], var [N, O]) and
``KL(cache)``.  The variational parameters and Z are ``nn.Parameter``s;
the hidden layer's KL anchor Z0 (and its identity mean's filter, under
``--identity-mean``) is a buffer, so no optimizer sees it.
"""

from __future__ import annotations

import typing

import torch
from torch import nn

from deepcgp_tpu_torch.config import JITTER
from deepcgp_tpu_torch.models.base_kernels import frozen_parameter
from deepcgp_tpu_torch.models.conv_kernels import MultiOutputConvKernel
from deepcgp_tpu_torch.ops import linalg
from deepcgp_tpu_torch.ops.conditional import multi_output_conditional


class LayerCache(typing.NamedTuple):
    Lm: torch.Tensor                  # chol(Kuu(Z)), [M, M]
    Lp: typing.Any = None             # ConvLayer, non-white: chol(Kuu(Z0))
    Lm_inv: typing.Any = None
    Lp_inv: typing.Any = None


def fresh_q_sqrt(Kuu: torch.Tensor, count: int, scale: float = 1.0):
    """``scale`` * chol(Kuu) tiled ``count`` times: the initial q_sqrt of a
    non-white layer (the JAX package's ``_init_qsqrt_conv`` and
    ``_init_qsqrt_svgp``)."""
    with torch.no_grad():
        Lu = linalg.cholesky(Kuu)
        return (Lu[None] * scale).expand(count, *Lu.shape).clone()


class ConvLayer(nn.Module):
    """Hidden layer: ``gp_count`` independent GPs shared across the P patch
    positions; ``num_outputs = P * gp_count``, laid out (P, R) so that the
    next layer reads it as an [Hout, Wout, gp_count] image.

    ``Z0`` is the frozen Z of the non-white KL prior: a detached copy of
    the initial Z unless given, so training Z never moves it and the KL
    sends no gradient to Z (the JAX package's ``stop_gradient(Z0)``)."""

    def __init__(self, base_kernel, Z, q_mu, q_sqrt, mean_function,
                 view, white: bool = False, gp_count: int = 1, Z0=None):
        super().__init__()
        self.base_kernel = base_kernel
        self.Z = frozen_parameter(Z)              # [M, L] inducing patches
        self.q_mu = frozen_parameter(q_mu)        # [M, R]
        self.q_sqrt = frozen_parameter(q_sqrt)    # [R, M, M], lower used
        self.register_buffer('Z0', (Z if Z0 is None else Z0).detach().clone())
        self.mean_function = mean_function
        self.view = view
        self.white = white
        self.gp_count = gp_count

    @property
    def num_outputs(self) -> int:
        return self.view.patch_count * self.gp_count

    @property
    def conv_kernel(self) -> MultiOutputConvKernel:
        return MultiOutputConvKernel(self.base_kernel, self.view.patch_count)

    def kuu_grams(self) -> tuple:
        """Kuu(Z) for the conditional, plus Kuu(Z0) of the KL prior when
        non-white: the grams the model factorizes in one batched call.
        Z0 is a buffer, so the prior's gram has gradient only to the
        kernel hyperparameters."""
        if self.white:
            return (self.conv_kernel.Kuu(self.Z),)
        return (self.conv_kernel.Kuu(self.Z),
                self.conv_kernel.Kuu(self.Z0.detach()))

    def make_cache(self, pairs: tuple) -> LayerCache:
        Lm, Lm_inv = pairs[0]
        if self.white:
            return LayerCache(Lm=Lm, Lm_inv=Lm_inv)
        Lp, Lp_inv = pairs[1]
        return LayerCache(Lm=Lm, Lp=Lp, Lm_inv=Lm_inv, Lp_inv=Lp_inv)

    def conditional_mean_var(self, cache: LayerCache, ND_X: torch.Tensor):
        """(mean [N, P*R], var [N, P*R])."""
        N = ND_X.shape[0]
        H, W = self.view.input_size
        NHWC_X = ND_X.reshape(N, H, W, self.view.feature_maps)
        NPL = self.view.extract_patches_NPL(NHWC_X)
        PNL = NPL.transpose(0, 1)
        Kuf = self.conv_kernel.Kuf_PNM(self.Z, PNL)           # [P, N, M]
        Knn = self.conv_kernel.Kdiag(PNL)                     # [P, N]
        mean, var = multi_output_conditional(
            Kuf, Knn, self.q_mu, Lm_inv=cache.Lm_inv, q_sqrt=self.q_sqrt,
            white=self.white)
        var = var.permute(2, 1, 0).reshape(N, self.num_outputs)
        mean = mean.reshape(N, self.num_outputs)
        return mean + self.mean_function(self.view.mean_view(NHWC_X, NPL)), var

    def KL(self, cache: LayerCache | None = None) -> torch.Tensor:
        """KL[q(u) || p(u)]; the non-white prior is Kuu(Z0), reused from
        ``cache`` (its factor and inverse) when given."""
        if self.white:
            return linalg.gauss_kl(self.q_mu, self.q_sqrt, None)
        if cache is not None and cache.Lp is not None:
            return linalg.gauss_kl(self.q_mu, self.q_sqrt, Lp=cache.Lp,
                                   Lp_inv=cache.Lp_inv)
        Kp = self.conv_kernel.Kuu(self.Z0.detach())
        return linalg.gauss_kl(self.q_mu, self.q_sqrt, Kp)


def kernel_gram(kernel, Z: torch.Tensor) -> torch.Tensor:
    """K(Z, Z) of a last-layer kernel: a patch-sum kernel's Kzz, or a plain
    base kernel's K (the JAX package's ``SVGPLayer._Kuu`` dispatch)."""
    return kernel.Kzz(Z) if hasattr(kernel, 'Kzz') else kernel.K(Z)


class SVGPLayer(nn.Module):
    """Final SVGP layer over the whole flattened image, one kernel shared
    by ``num_outputs`` latent GPs: a patch-sum kernel over patch inducing
    features, or a plain base kernel (the ARD RBF of ``last_kernel='rbf'``)
    over inducing points.  Its KL prior is Kuu of the current Z, so the
    conditional's factor doubles as the prior's."""

    def __init__(self, kernel, Z, q_mu, q_sqrt, mean_function,
                 white: bool = False, num_outputs: int = 10):
        super().__init__()
        self.kernel = kernel
        self.Z = frozen_parameter(Z)              # [M, L]
        self.q_mu = frozen_parameter(q_mu)        # [M, R]
        self.q_sqrt = frozen_parameter(q_sqrt)    # [R, M, M]
        self.mean_function = mean_function
        self.white = white
        self.num_outputs = num_outputs

    def Kuu(self, Z: torch.Tensor) -> torch.Tensor:
        return linalg.add_jitter(kernel_gram(self.kernel, Z), JITTER)

    def kuu_grams(self) -> tuple:
        return (self.Kuu(self.Z),)

    def make_cache(self, pairs: tuple) -> LayerCache:
        Lm, Lm_inv = pairs[0]
        return LayerCache(Lm=Lm, Lm_inv=Lm_inv)

    def conditional_mean_var(self, cache: LayerCache, ND_X: torch.Tensor):
        """(mean [N, R], var [N, R]).  A patch-sum kernel gives Kuf and
        Kdiag from one fused call; a plain kernel K(X, Z) and its constant
        Kdiag."""
        if hasattr(self.kernel, 'Kzx_NM_and_Kdiag'):
            Kuf, Knn = self.kernel.Kzx_NM_and_Kdiag(self.Z, ND_X)
        else:
            Kuf, Knn = self.kernel.K(ND_X, self.Z), self.kernel.Kdiag(ND_X)
        mean, var = multi_output_conditional(
            Kuf[None], Knn[None], self.q_mu, Lm_inv=cache.Lm_inv,
            q_sqrt=self.q_sqrt, white=self.white)
        return mean[:, 0, :] + self.mean_function(ND_X), var[:, 0].T

    def KL(self, cache: LayerCache | None = None) -> torch.Tensor:
        if self.white:
            return linalg.gauss_kl(self.q_mu, self.q_sqrt, None)
        if cache is not None:
            return linalg.gauss_kl(self.q_mu, self.q_sqrt, Lp=cache.Lm,
                                   Lp_inv=cache.Lm_inv)
        return linalg.gauss_kl(self.q_mu, self.q_sqrt, self.Kuu(self.Z))
