"""Linear-algebra primitives of the sparse variational GP layers, with the
gradients training needs.

Counterpart of ``deepcgp_tpu/ops/linalg.py``.  The JAX package's custom
VJPs become ``torch.autograd.Function``s with the same backward formulas:
the Cholesky-plus-inverse's backward is matrix products only (no
triangular solve), and the two self-products (``syrk_sum``,
``gram_syrk``) take their collapsed one-product backward.
"""

from __future__ import annotations

import torch

from deepcgp_tpu_torch import config
from deepcgp_tpu_torch.ops import cuda_linalg
from deepcgp_tpu_torch.parallel import sharding


def add_jitter(K: torch.Tensor, jitter: float | None = None) -> torch.Tensor:
    """K + jitter * I on the last two dims."""
    if jitter is None:
        jitter = config.JITTER
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return K + jitter * eye


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN, not an exception, on a non-PD input
    (the JAX package's convention, which callers' finite checks rely on)."""
    L, info = torch.linalg.cholesky_ex(K)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float('nan')), L)


def _bigchol_slice(K: torch.Tensor) -> bool:
    """Shapes above M = 512 that the JAX package factors with its M > 512
    kernels (the factor-only driver and the block-doubling triangular
    inverse), up to the largest matrix K1 and K3 take."""
    M = K.shape[-1]
    return (K.dtype == torch.float32 and 512 < M <= cuda_linalg.MAX_M
            and M % 128 == 0 and ((M // 128) & (M // 128 - 1)) == 0)


def _chol_inv_impl(K: torch.Tensor):
    """(chol(K), chol(K)^-1) for K [..., M, M] SPD (0 or 1 batch dims).

    float32 with M a multiple of 64 and M <= 512, or M = 1024 (the JAX
    package's two kernel routes, the second capped at K1's and K3's
    largest matrix) goes to K1 then K3: two launches on the card, the
    kernels' plain versions on the CPU.  Every other shape or dtype takes
    ``torch.linalg.cholesky`` plus one triangular solve, as the JAX package
    takes XLA's."""
    M = K.shape[-1]
    if K.ndim in (2, 3) and (
            (K.dtype == torch.float32 and M % 64 == 0 and M <= 512)
            or _bigchol_slice(K)):
        KB = K[None] if K.ndim == 2 else K
        L, Linv = cuda_linalg.chol_inv_batched(KB.contiguous())
        return (L[0], Linv[0]) if K.ndim == 2 else (L, Linv)
    L = cholesky(K)
    eye = torch.eye(M, dtype=K.dtype, device=K.device).expand(K.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return L, Linv


def _T(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


class _CholWithInv(torch.autograd.Function):
    """With L^-1 in hand the Cholesky's reverse is products only:

        Lbar = tril(gL - L^-T gLinv L^-T)     (the inverse's cotangent)
        Kbar = sym(L^-T Phi(L^T Lbar) L^-1),  Phi = tril, halved diagonal.
    """

    @staticmethod
    def forward(ctx, K):
        L, Linv = _chol_inv_impl(K)
        ctx.save_for_backward(L, Linv)
        return L, Linv

    @staticmethod
    def backward(ctx, gL, gLinv):
        L, Linv = ctx.saved_tensors
        if gL is None:
            gL = torch.zeros_like(L)
        if gLinv is None:
            gLinv = torch.zeros_like(L)
        Lbar = torch.tril(gL - _T(Linv) @ gLinv @ _T(Linv))
        P = _T(L) @ Lbar
        Phi = torch.tril(P) - 0.5 * torch.diag_embed(
            torch.diagonal(P, dim1=-2, dim2=-1))
        Kbar = _T(Linv) @ Phi @ Linv
        return 0.5 * (Kbar + _T(Kbar))


def chol_with_inv(K: torch.Tensor):
    """Differentiable (chol(K), chol(K)^-1) of SPD K [..., M, M] (0 or 1
    batch dims); the backward is matrix products only."""
    return _CholWithInv.apply(K)


class _TrilLogdet(torch.autograd.Function):
    """Only the diagonal is live in either direction: forward saves it,
    backward puts g / diag back on it."""

    @staticmethod
    def forward(ctx, L):
        d = torch.diagonal(L, dim1=-2, dim2=-1)
        ctx.save_for_backward(d)
        return torch.log(torch.abs(d)).sum()

    @staticmethod
    def backward(ctx, g):
        d, = ctx.saved_tensors
        return torch.diag_embed(g / d)


def tril_logdet(L: torch.Tensor) -> torch.Tensor:
    """sum(log|diag(L)|) over every leading batch dim of a triangular
    factor stack [..., M, M]: half the log-determinant sum."""
    return _TrilLogdet.apply(L)


class _SyrkSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Lq):
        ctx.save_for_backward(Lq)
        return torch.einsum('rmk,rnk->mn', Lq, Lq)

    @staticmethod
    def backward(ctx, C):
        Lq, = ctx.saved_tensors
        return torch.einsum('mn,rnk->rmk', C + C.T, Lq)


def syrk_sum(Lq: torch.Tensor) -> torch.Tensor:
    """T = sum_r Lq_r Lq_r^T; the two operands are one tensor, so the
    cotangent collapses to (C + C^T) Lq, one product."""
    return _SyrkSum.apply(Lq)


class _GramSyrk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X):
        ctx.save_for_backward(X)
        return X @ _T(X)

    @staticmethod
    def backward(ctx, C):
        X, = ctx.saved_tensors
        return (C + _T(C)) @ X


def gram_syrk(X: torch.Tensor) -> torch.Tensor:
    """G = X X^T over the last two dims ([..., N, D] -> [..., N, N]) with
    the one-product backward (C + C^T) X."""
    return _GramSyrk.apply(X)


def gauss_kl(q_mu: torch.Tensor, q_sqrt: torch.Tensor,
             K: torch.Tensor | None = None, *,
             Lp: torch.Tensor | None = None,
             Lp_inv: torch.Tensor | None = None) -> torch.Tensor:
    """KL[q(u) || p(u)] summed over independent GPs (gpflow 1.x
    ``gauss_kl``): q_mu [M, R], q_sqrt [R, M, M] (lower triangle used).
    The prior is white (no K, Lp or Lp_inv), given by its factor and the
    factor's inverse (``Lp``, ``Lp_inv``), or by K [M, M] (factorized here
    unless ``Lp`` is given).

    KL = 0.5 * sum_r [tr(K^-1 S_r) + m_r^T K^-1 m_r - M - logdet(S_r)
                      + logdet(K)].

    In the factor form a float32 KL evaluates T = sum_r Lq_r Lq_r^T in
    float64 and rounds it back; the rest runs in float32, as the reference
    does.  With Kuu ill-conditioned (M = 1024, jitter 1e-3) the trace term
    is a sum of ~1e4-sized products that nearly cancel, and cuBLAS's
    float32 T (10 x 1024 terms an entry) left the card's loss 20x and the
    hyperparameters' gradients 5x farther from float64 than the CPU's;
    T alone in float64 brings them back to the CPU's distance, W = Lp^-T
    Lp^-1 or the trace alone in float64 leave them where all-float32 does
    (``tools/torch_grad_witness.py``).  The other two forms evaluate a
    float32 KL wholly in float64.

    Under a model axis the GP axis R is sharded: this rank evaluates the
    KL of its block of q_mu and q_sqrt, and the blocks' KLs are summed
    over the model group (``parallel.sharding``)."""
    if Lp_inv is not None and Lp is None:
        raise ValueError('gauss_kl: Lp_inv requires its factor Lp')
    block = sharding.model_block(q_mu.shape[1], 'the GP axis R of the KL',
                                 q_sqrt.shape)
    if block is not None:
        q_mu, q_sqrt, K, Lp, Lp_inv = sharding.replicate_in(
            q_mu, q_sqrt, K, Lp, Lp_inv)
        return sharding.reduce_out(_gauss_kl_dtype(
            q_mu[:, block], q_sqrt[block], K, Lp=Lp, Lp_inv=Lp_inv))
    return _gauss_kl_dtype(q_mu, q_sqrt, K, Lp=Lp, Lp_inv=Lp_inv)


def _gauss_kl_dtype(q_mu, q_sqrt, K, *, Lp, Lp_inv):
    if q_mu.dtype == torch.float32 and Lp_inv is None:
        up = (lambda x: None if x is None else x.double())
        return _gauss_kl(up(q_mu), up(q_sqrt), up(K), Lp=up(Lp),
                         Lp_inv=None).float()
    return _gauss_kl(q_mu, q_sqrt, K, Lp=Lp, Lp_inv=Lp_inv)


def _gauss_kl(q_mu, q_sqrt, K, *, Lp, Lp_inv):
    M, R = q_mu.shape
    Lq = torch.tril(q_sqrt)
    if K is None and Lp is None and Lp_inv is None:
        alpha = q_mu
        trace = Lq.square().sum()
        logdet_prior = q_mu.new_zeros(())
    elif Lp_inv is not None:
        T = syrk_sum(Lq.double() if Lq.dtype == torch.float32 else Lq)
        W = _T(Lp_inv) @ Lp_inv                              # Lp^-T Lp^-1
        trace = (W * T.to(W.dtype)).sum()
        alpha = Lp_inv @ q_mu
        logdet_prior = R * 2.0 * tril_logdet(Lp)
    else:
        if Lp is None:
            Lp = cholesky(K)
        T = syrk_sum(Lq)
        V = torch.linalg.solve_triangular(Lp, torch.cat([T, q_mu], dim=1),
                                          upper=False)       # [M, M+R]
        alpha = V[:, M:]
        X = torch.linalg.solve_triangular(Lp.T, V[:, :M], upper=True)
        trace = torch.diagonal(X).sum()
        logdet_prior = R * 2.0 * tril_logdet(Lp)
    mahalanobis = alpha.square().sum()
    logdet_q = 2.0 * tril_logdet(q_sqrt)
    return 0.5 * (trace + mahalanobis - M * R - logdet_q + logdet_prior)
