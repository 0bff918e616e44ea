"""Batched Cholesky factor plus explicit inverse: the CUDA base case and
its blocked driver.

Counterpart of the lower-triangular path of
``deepcgp_tpu/ops/pallas_linalg.py``.  :func:`chol_inv_base` factors a
batch of [P, P] panels in one launch of ``csrc/chol_inv.cu``;
:func:`chol_inv_batched` is the right-looking blocked driver around it,
whose panel solves, trailing downdates and block forward substitution are
full-f32 matrix products (TF32 is off, see ``config``).

A non-PD batch element gives NaN in its L and L^-1 and leaves the others
untouched, as ``torch.linalg.cholesky`` in JAX's NaN convention would:
callers detect a failed factorization by finiteness.
"""

from __future__ import annotations

import ctypes

import torch

from deepcgp_tpu_torch.ops import cuda_build

# Panel width of the driver, and the largest matrix the kernel takes (its
# [P, 2P] working matrix is 32 KB of shared memory at 64).
PANEL = 64


def chol_inv_base_plain(D: torch.Tensor):
    """Plain PyTorch version of the kernel, step for step: Gaussian
    elimination on [D | I] advanced over the whole batch at once."""
    b, P, _ = D.shape
    eye = torch.eye(P, dtype=D.dtype, device=D.device).expand(b, P, P)
    W = torch.cat([D, eye], dim=2).clone()
    L = torch.zeros_like(D)
    Linv = torch.empty_like(D)
    for j in range(P):
        rowj = W[:, j:j + 1, :]                              # [b, 1, 2P]
        rsq = torch.rsqrt(rowj[:, :, j:j + 1])               # [b, 1, 1]
        Linv[:, j:j + 1, :] = rowj[:, :, P:] * rsq
        cvec = W[:, j:, j:j + 1] * rsq                       # [b, P-j, 1]
        L[:, j:, j:j + 1] = cvec
        if j + 1 < P:
            W[:, j + 1:, :] -= (cvec[:, 1:] * rsq) * rowj
    return L, Linv


def _launch_chol_inv(D: torch.Tensor):
    b, P, _ = D.shape
    L = torch.empty_like(D)
    Linv = torch.empty_like(D)
    fn = cuda_build.function(
        'chol_inv', 'chol_inv_base',
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(D.device).cuda_stream
    cuda_build.check(fn(D.data_ptr(), L.data_ptr(), Linv.data_ptr(), b, P,
                        stream), 'chol_inv_base')
    chol_inv_base.launches += 1
    return L, Linv


def chol_inv_base(D: torch.Tensor):
    """[b, P, P] symmetric (lower triangle read) -> (chol(D), chol(D)^-1).

    A CUDA tensor launches the kernel (float32, contiguous, P <= 64) or
    raises; a CPU tensor takes :func:`chol_inv_base_plain`."""
    if D.device.type == 'cpu':
        return chol_inv_base_plain(D)
    if D.device.type != 'cuda':
        raise ValueError(f'chol_inv_base: unsupported device {D.device}')
    if D.dtype != torch.float32:
        raise TypeError(f'chol_inv_base: float32 only, got {D.dtype}')
    if D.ndim != 3 or D.shape[1] != D.shape[2] or not 0 < D.shape[1] <= PANEL:
        raise ValueError(f'chol_inv_base: need [b, P, P] with P <= {PANEL},'
                         f' got {tuple(D.shape)}')
    if not D.is_contiguous():
        raise ValueError('chol_inv_base: input must be contiguous')
    return _launch_chol_inv(D)


chol_inv_base.launches = 0


def chol_inv_batched(A: torch.Tensor):
    """Blocked right-looking Cholesky of a batch of SPD matrices with the
    explicit inverse of the factor: A [B, M, M], M a multiple of PANEL (or
    below it) -> (L, L^-1).  The JAX driver's block identities,

        L_kk, L_kk^-1 = base(rem_kk);  L_21 = A_21 L_kk^-T;
        rem <- rem_22 - L_21 L_21^T;
        X_kk = L_kk^-1;  X_i,:i = -L_ii^-1 (L_i,:i X_:i,:i),

    with the forward substitution taken a whole block row per product
    (2 products per row instead of one per block pair): the driver's time
    on the card is launches, not arithmetic.
    """
    B, M, M2 = A.shape
    P = min(PANEL, M)
    if M != M2 or M % P:
        raise ValueError(f'chol_inv_batched: {tuple(A.shape)} with panel {P}')
    np_ = M // P
    if np_ == 1:
        return chol_inv_base(A.contiguous())

    L = torch.zeros_like(A)
    X = torch.zeros_like(A)
    rem = A
    for k in range(np_):
        s = k * P
        Lkk, Lkkinv = chol_inv_base(rem[:, :P, :P].contiguous())
        L[:, s:s + P, s:s + P] = Lkk
        X[:, s:s + P, s:s + P] = Lkkinv
        if k + 1 < np_:
            L21 = rem[:, P:, :P] @ Lkkinv.transpose(1, 2)      # [B, m, P]
            L[:, s + P:, s:s + P] = L21
            rem = rem[:, P:, P:] - L21 @ L21.transpose(1, 2)
    for i in range(1, np_):
        s = i * P
        X[:, s:s + P, :s] = -(X[:, s:s + P, s:s + P]
                              @ (L[:, s:s + P, :s] @ X[:, :s, :s]))
    return L, X
