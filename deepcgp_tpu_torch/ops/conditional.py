"""Multi-output sparse variational GP conditional (counterpart of
``deepcgp_tpu/ops/conditional.py``).

Shapes (P patch positions, M inducing, N batch, R GPs per position):
Kmn [P, N, M] (the 'pnm' layout), Knn [P, N] (diagonal) or [P, N, N]
(``full_cov``), f [M, R], q_sqrt [R, M, M] lower-triangular.  Returns
(fmean [N, P, R], fvar [R, P, N] or [R, P, N, N]).
"""

from __future__ import annotations

import torch

from deepcgp_tpu_torch.parallel import sharding


def multi_output_conditional(Kmn: torch.Tensor, Knn: torch.Tensor,
                             f: torch.Tensor, *, Lm_inv: torch.Tensor,
                             q_sqrt: torch.Tensor | None = None,
                             white: bool = False, full_cov: bool = False,
                             shard_outputs: bool = False):
    """q(g1) = int q(g2) p(g1 | g2) with p(g2) = N(0, Kmm) and
    q(g2) = N(f, q_sqrt q_sqrt^T), given Lm_inv = chol(Kmm)^-1.  Every
    triangular solve is a product with Lm_inv.

    ``shard_outputs`` (the last layer, P == 1): under a model axis the GP
    axis R of the q_sqrt term is sharded -- this rank multiplies A by its
    block of the R factors, and the block's row norms are gathered along
    R (``parallel.sharding``)."""
    A = Kmn @ Lm_inv.T                                     # rows of Lm^-1 Kmn
    R = f.shape[1]
    if full_cov:
        fvar = (Knn - A @ A.transpose(-1, -2)).expand(R, *Knn.shape)
    else:
        fvar = (Knn - A.square().sum(-1)).expand(R, *Knn.shape)  # [R, P, N]
    if not white:
        A = A @ Lm_inv                                     # rows of Lm^-T A
    fmean = torch.einsum('pnm,mr->npr', A, f)
    if q_sqrt is not None:
        Lq = torch.tril(q_sqrt)                            # [R, M, M]
        if full_cov:
            # Sampling and evaluation at a small N: the batched form.
            LTA = torch.einsum('rms,pnm->rpns', Lq, A)     # [R, P, N, M]
            fvar = fvar + LTA @ LTA.transpose(-1, -2)
        else:
            # Row-wise ||A L_r||^2 for every r as one [P*N, M] x [M, R*M]
            # product.
            P, N, M = A.shape
            block = (sharding.model_block(R, 'the GP axis R', q_sqrt.shape)
                     if shard_outputs and P == 1 else None)
            if block is None:
                LTA = A.reshape(P * N, M) @ Lq.permute(1, 0, 2).reshape(
                    M, R * M)
                qterm = LTA.reshape(P * N, R, M).square().sum(-1)  # [P*N, R]
            else:
                A_in, q_in = sharding.replicate_in(A, q_sqrt)
                Lb = torch.tril(q_in[block])                   # [Rb, M, M]
                Rb = Lb.shape[0]
                LTA = A_in.reshape(N, M) @ Lb.permute(1, 0, 2).reshape(
                    M, Rb * M)
                qterm = sharding.gather_out(
                    LTA.reshape(N, Rb, M).square().sum(-1), 1)  # [N, R]
            fvar = fvar + qterm.reshape(P, N, R).permute(2, 0, 1)
    # A marginal variance is >= 0; float32 cancellation in Knn - ||A||^2 on
    # an ill-conditioned Kmm can push it below, and sqrt(var) (or the
    # sampling Cholesky of the full covariance) would NaN.  The full
    # covariance has its diagonal floored by subtracting its negative
    # part; the off-diagonal entries stay as they are.
    if full_cov:
        diag = fvar.diagonal(dim1=-2, dim2=-1)             # [R, P, N]
        return fmean, fvar - torch.diag_embed(diag.clamp_max(0.0))
    return fmean, torch.maximum(fvar, fvar.new_zeros(()))
