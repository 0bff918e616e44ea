"""Multi-output sparse variational GP conditional, diagonal covariance
(counterpart of ``deepcgp_tpu/ops/conditional.py``; ``full_cov`` is not
ported yet).

Shapes (P patch positions, M inducing, N batch, R GPs per position):
Kmn [P, N, M] (the 'pnm' layout), Knn [P, N], f [M, R], q_sqrt [R, M, M]
lower-triangular.  Returns (fmean [N, P, R], fvar [R, P, N]).
"""

from __future__ import annotations

import torch


def multi_output_conditional(Kmn: torch.Tensor, Knn: torch.Tensor,
                             f: torch.Tensor, *, Lm_inv: torch.Tensor,
                             q_sqrt: torch.Tensor | None = None,
                             white: bool = False):
    """q(g1) = int q(g2) p(g1 | g2) with p(g2) = N(0, Kmm) and
    q(g2) = N(f, q_sqrt q_sqrt^T), given Lm_inv = chol(Kmm)^-1.  Every
    triangular solve is a product with Lm_inv."""
    A = Kmn @ Lm_inv.T                                     # rows of Lm^-1 Kmn
    R = f.shape[1]
    fvar = (Knn - A.square().sum(-1)).expand(R, *Knn.shape)  # [R, P, N]
    if not white:
        A = A @ Lm_inv                                     # rows of Lm^-T A
    fmean = torch.einsum('pnm,mr->npr', A, f)
    if q_sqrt is not None:
        # Row-wise ||A L_r||^2 for every r as one [P*N, M] x [M, R*M] product.
        P, N, M = A.shape
        Lq = torch.tril(q_sqrt)                            # [R, M, M]
        LTA = A.reshape(P * N, M) @ Lq.permute(1, 0, 2).reshape(M, R * M)
        qterm = LTA.reshape(P * N, R, M).square().sum(-1)  # [P*N, R]
        fvar = fvar + qterm.reshape(P, N, R).permute(2, 0, 1)
    # A marginal variance is >= 0; float32 cancellation in Knn - ||A||^2 on
    # an ill-conditioned Kmm can push it below, and sqrt(var) would NaN.
    return fmean, torch.maximum(fvar, fvar.new_zeros(()))
