"""GP layers: the hidden convolutional layer and the final SVGP layer
(counterpart of ``deepcgp_tpu/models/layers.py``).

Each layer exposes ``kuu_grams()`` (the [M, M] grams to factorize),
``make_cache(pairs)`` (a LayerCache from their (L, L^-1) pairs),
``precompute()`` (the layer's own cache, its grams factorized in one
batched call), ``conditional_mean_var(cache, ND_X, full_cov)`` ->
(mean [N, O], var [N, O] or [N, N, O]), ``sample_from_conditional`` and
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
from deepcgp_tpu_torch.parallel import sharding


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


def _precompute(layer) -> LayerCache:
    """A layer's cache on its own: its grams factorized, with their
    inverses, in one batched ``chol_with_inv`` (one K1 + one K3 on the
    card where the shape takes them)."""
    L, Linv = linalg.chol_with_inv(torch.stack(layer.kuu_grams()))
    return layer.make_cache(tuple(zip(L.unbind(0), Linv.unbind(0))))


def _sample_from_conditional(layer, ND_X, full_cov, generator, noise):
    """(sample, mean, var) of q(f | ND_X), with standard normals from
    ``noise`` when given (the shape of the mean, or [O, N] for the full
    covariance), else from ``generator``.  The full covariance draws one
    correlated sample per output through chol(cov + jitter I) over N, so
    it needs the whole batch on every rank: it refuses a data axis.  Under
    one, ``noise`` holds the global batch's rows, and a draw from
    ``generator`` is the global batch's, of which each rank keeps its
    rows."""
    if (noise is None) == (generator is None):
        raise ValueError('sample_from_conditional: pass exactly one of '
                         'generator, noise')
    if full_cov and sharding.data_size() > 1:
        raise ValueError('sample_from_conditional: the full covariance '
                         'couples the rows that a data axis splits')
    mean, var = layer.conditional_mean_var(layer.precompute(), ND_X,
                                           full_cov=full_cov)
    N, O = mean.shape
    shape = (O, N) if full_cov else (N, O)
    if noise is not None:
        z = torch.as_tensor(noise, dtype=mean.dtype, device=mean.device)
        if z.shape != shape:
            z = sharding.own_rows(z)
        if z.shape != shape:
            raise ValueError(f'noise is {tuple(z.shape)}, the sample draws '
                             f'{shape}')
    else:
        z = sharding.normal(shape, generator, dtype=mean.dtype,
                            device=mean.device)
    if full_cov:
        cov = var.permute(2, 0, 1)                               # [O, N, N]
        L = linalg.cholesky(linalg.add_jitter(cov, JITTER))
        sample = mean + torch.einsum('onk,ok->no', L, z)
    else:
        sample = mean + z * torch.sqrt(var + JITTER)
    return sample, mean, var


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

    def precompute(self) -> LayerCache:
        return _precompute(self)

    def conditional_mean_var(self, cache: LayerCache, ND_X: torch.Tensor,
                             full_cov: bool = False):
        """(mean [N, P*R], var [N, P*R], or [N, N, P*R] with
        ``full_cov``).  Under a model axis the patch axis P is sharded:
        this rank evaluates Kuf and the conditional on its block of the
        patches, and the block's mean and variance are gathered along P
        before they leave, so the sample and everything after it are the
        single-process ones (``parallel.sharding``)."""
        N = ND_X.shape[0]
        H, W = self.view.input_size
        NHWC_X = ND_X.reshape(N, H, W, self.view.feature_maps)
        NPL = self.view.extract_patches_NPL(NHWC_X)
        P = self.view.patch_count
        block = sharding.model_block(P, 'the patch axis P', NPL.shape)
        if block is None:
            kernel, PNL = self.conv_kernel, NPL.transpose(0, 1)
            Z, q_mu, q_sqrt, Lm_inv = (self.Z, self.q_mu, self.q_sqrt,
                                       cache.Lm_inv)
        else:
            # The region's replicated inputs enter through replicate_in
            # (the base kernel's parameters too); the mean view below
            # reads the patches outside it.
            NPL_in, Z, q_mu, q_sqrt, Lm_inv = sharding.replicate_in(
                NPL, self.Z, self.q_mu, self.q_sqrt, cache.Lm_inv)
            kernel = MultiOutputConvKernel(
                sharding.replicate_module(self.base_kernel), P)
            PNL = NPL_in.transpose(0, 1)[block]
        Kuf = kernel.Kuf_PNM(Z, PNL)                          # [P, N, M]
        if full_cov:
            Knn = kernel.Kff(PNL)                             # [P, N, N]
        else:
            Knn = kernel.Kdiag(PNL)                           # [P, N]
        mean, var = multi_output_conditional(
            Kuf, Knn, q_mu, Lm_inv=Lm_inv, q_sqrt=q_sqrt,
            white=self.white, full_cov=full_cov)
        if block is not None:
            mean = sharding.gather_out(mean, 1)               # [N, P, R]
            var = sharding.gather_out(var, 1)                 # [R, P, N(, N)]
        if full_cov:
            var = var.permute(2, 3, 1, 0).reshape(N, N, self.num_outputs)
        else:
            var = var.permute(2, 1, 0).reshape(N, self.num_outputs)
        mean = mean.reshape(N, self.num_outputs)
        return mean + self.mean_function(self.view.mean_view(NHWC_X, NPL)), var

    def sample_from_conditional(self, ND_X: torch.Tensor,
                                full_cov: bool = False, *, generator=None,
                                noise=None):
        """(sample, mean, var) of q(f | ND_X), from this layer's own
        cache."""
        return _sample_from_conditional(self, ND_X, full_cov, generator,
                                        noise)

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

    def precompute(self) -> LayerCache:
        return _precompute(self)

    def conditional_mean_var(self, cache: LayerCache, ND_X: torch.Tensor,
                             full_cov: bool = False):
        """(mean [N, R], var [N, R], or [N, N, R] with ``full_cov``).  A
        patch-sum kernel gives Kuf and Kdiag from one fused call; a plain
        kernel K(X, Z) and its constant Kdiag.  The full covariance takes
        Kuf alone and the kernel's K over the batch."""
        if full_cov:
            Kuf = (self.kernel.Kzx_NM(self.Z, ND_X)
                   if hasattr(self.kernel, 'Kzx_NM')
                   else self.kernel.K(ND_X, self.Z))
            Knn = self.kernel.K(ND_X)
        elif hasattr(self.kernel, 'Kzx_NM_and_Kdiag'):
            Kuf, Knn = self.kernel.Kzx_NM_and_Kdiag(self.Z, ND_X)
        else:
            Kuf, Knn = self.kernel.K(ND_X, self.Z), self.kernel.Kdiag(ND_X)
        mean, var = multi_output_conditional(
            Kuf[None], Knn[None], self.q_mu, Lm_inv=cache.Lm_inv,
            q_sqrt=self.q_sqrt, white=self.white, full_cov=full_cov,
            shard_outputs=True)
        var = var[:, 0].permute(1, 2, 0) if full_cov else var[:, 0].T
        return mean[:, 0, :] + self.mean_function(ND_X), var

    def sample_from_conditional(self, ND_X: torch.Tensor,
                                full_cov: bool = False, *, generator=None,
                                noise=None):
        """See :meth:`ConvLayer.sample_from_conditional`."""
        return _sample_from_conditional(self, ND_X, full_cov, generator,
                                        noise)

    def KL(self, cache: LayerCache | None = None) -> torch.Tensor:
        if self.white:
            return linalg.gauss_kl(self.q_mu, self.q_sqrt, None)
        if cache is not None:
            return linalg.gauss_kl(self.q_mu, self.q_sqrt, Lp=cache.Lm,
                                   Lp_inv=cache.Lm_inv)
        return linalg.gauss_kl(self.q_mu, self.q_sqrt, self.Kuu(self.Z))
