"""Linear-algebra primitives of the sparse variational GP layers (forward
only: serving needs no gradient).

Counterpart of ``deepcgp_tpu/ops/linalg.py``.
"""

from __future__ import annotations

import torch

from deepcgp_tpu_torch import config
from deepcgp_tpu_torch.ops import cuda_linalg


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
    """Shapes the JAX package factors with its M > 512 kernels (the
    factor-only driver and the block-doubling triangular inverse)."""
    M = K.shape[-1]
    return (K.dtype == torch.float32 and M > 512 and M % 128 == 0
            and ((M // 128) & (M // 128 - 1)) == 0)


def chol_with_inv(K: torch.Tensor):
    """(chol(K), chol(K)^-1) for K [..., M, M] SPD (0 or 1 batch dims).

    float32 with M a multiple of 64 and M <= 512 goes to the blocked
    driver around the CUDA base kernel (its plain version for a CPU
    tensor).  The M > 512 shapes the JAX package gives to its other
    kernels are not ported yet and raise on the card.  Every other shape or
    dtype takes ``torch.linalg.cholesky`` plus one triangular solve, as the
    JAX package takes XLA's."""
    M = K.shape[-1]
    if K.dtype == torch.float32 and M % 64 == 0 and M <= 512 and K.ndim in (2, 3):
        KB = K[None] if K.ndim == 2 else K
        L, Linv = cuda_linalg.chol_inv_batched(KB)
        return (L[0], Linv[0]) if K.ndim == 2 else (L, Linv)
    if _bigchol_slice(K) and K.device.type == 'cuda':
        raise NotImplementedError(
            f'chol_with_inv at M={M}: the M=1024 kernels (K3, ROADMAP queue '
            'B) are not ported yet')
    L = cholesky(K)
    eye = torch.eye(M, dtype=K.dtype, device=K.device).expand(K.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return L, Linv
