"""Batched Cholesky factors, their inverses and triangular inverses: the
CUDA base cases and their blocked drivers.

Counterpart of ``deepcgp_tpu/ops/pallas_linalg.py``.  Three kernels, each
one launch over a batch of [P, P] matrices (P <= 128):

* :func:`chol_inv_base` (``csrc/chol_inv.cu``, K1): lower factor and its
  inverse, under :func:`chol_inv_batched` (factor plus inverse) and
  :func:`chol_factor_batched` (factor only);
* :func:`chol_inv_base_upper` (``csrc/chol_inv.cu``, K2): upper factor
  R (R R^T = D) and its inverse, under the NatGrad drivers
  :func:`chol_inv_batched_upper` and :func:`chol_right_solve_upper`;
* :func:`tri_inv_base` (``csrc/tri_inv.cu``, K3): inverse of a lower
  factor, under :func:`tri_inv_doubling`.

The drivers' panel solves, trailing downdates and block substitutions are
full-f32 matrix products (TF32 is off, see ``config``).

A non-PD batch element gives NaN in its factor and inverse and leaves the
others untouched, as ``torch.linalg.cholesky`` in JAX's NaN convention
would: callers detect a failed factorization by finiteness.
"""

from __future__ import annotations

import ctypes

import torch

from deepcgp_tpu_torch.ops import cuda_build

# Default panel of the drivers (the JAX package's PANEL), and the largest
# matrix the kernels take: K1/K2 keep a [P, 2P] working matrix in shared
# memory (128 KB at 128), K3 L and X^T (132 KB at 128).
PANEL = 64
MAX_P = 128


def _T(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _check_device(what: str, A: torch.Tensor, multiple: int = 1) -> bool:
    """True for a CPU tensor (the plain version runs); for a CUDA tensor,
    raise on anything the kernel does not take and return False."""
    if A.device.type == 'cpu':
        return True
    if A.device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {A.device}')
    if A.dtype != torch.float32:
        raise TypeError(f'{what}: float32 only, got {A.dtype}')
    if (A.ndim != 3 or A.shape[1] != A.shape[2]
            or not 0 < A.shape[1] <= MAX_P or A.shape[1] % multiple):
        raise ValueError(f'{what}: need [b, P, P] with P <= {MAX_P}'
                         f'{f" and P % {multiple} == 0" if multiple > 1 else ""},'
                         f' got {tuple(A.shape)}')
    if not A.is_contiguous():
        raise ValueError(f'{what}: input must be contiguous')
    return False


def _launch(library: str, symbol: str, A: torch.Tensor, n_out: int):
    """Launch ``symbol`` of ``library`` on A [b, P, P]: (A, out..., b, P,
    stream); returns the ``n_out`` outputs, allocated like A."""
    b, P, _ = A.shape
    outs = [torch.empty_like(A) for _ in range(n_out)]
    fn = cuda_build.function(
        library, symbol,
        [ctypes.c_void_p] * (1 + n_out) + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(A.device).cuda_stream
    cuda_build.check(fn(A.data_ptr(), *[o.data_ptr() for o in outs], b, P,
                        stream), symbol)
    return outs


# ------------------------------------------------------------------- K1


def chol_inv_base_plain(D: torch.Tensor):
    """Plain PyTorch version of K1, step for step: Gaussian elimination on
    [D | I] advanced over the whole batch at once."""
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


def chol_inv_base(D: torch.Tensor):
    """[b, P, P] symmetric -> (chol(D), chol(D)^-1), L lower.  The whole of
    D is read, both triangles, as the JAX kernel reads it: a matrix
    meaningful in its lower triangle only goes through
    :func:`sym_from_tril` first.

    A CUDA tensor launches K1 (float32, contiguous, P <= 128) or raises; a
    CPU tensor takes :func:`chol_inv_base_plain`."""
    if _check_device('chol_inv_base', D):
        return chol_inv_base_plain(D)
    L, Linv = _launch('chol_inv', 'chol_inv_base', D, 2)
    chol_inv_base.launches += 1
    return L, Linv


chol_inv_base.launches = 0


def _factor_lower(A: torch.Tensor, P: int):
    """Right-looking factor phase: A [B, M, M] SPD -> (L dense lower, the
    inverses of its M/P diagonal blocks), with

        L_kk, L_kk^-1 = base(rem_kk);  L_21 = A_21 L_kk^-T;
        rem <- rem_22 - L_21 L_21^T."""
    M = A.shape[-1]
    L = torch.zeros_like(A)
    Dinv = []
    rem = A
    for k in range(M // P):
        s = k * P
        Lkk, Lkkinv = chol_inv_base(rem[:, :P, :P].contiguous())
        L[:, s:s + P, s:s + P] = Lkk
        Dinv.append(Lkkinv)
        if s + P < M:
            L21 = rem[:, P:, :P] @ _T(Lkkinv)                # [B, m, P]
            L[:, s + P:, s:s + P] = L21
            rem = rem[:, P:, P:] - L21 @ _T(L21)
    return L, Dinv


def _panel(what: str, A: torch.Tensor, panel: int) -> int:
    B, M, M2 = A.shape
    P = min(panel, M)
    if M != M2 or M % P:
        raise ValueError(f'{what}: {tuple(A.shape)} with panel {P}')
    return P


def chol_inv_batched(A: torch.Tensor):
    """Blocked right-looking Cholesky of a batch of SPD matrices with the
    explicit inverse of the factor: A [B, M, M], M a multiple of PANEL
    (or below it) -> (L, L^-1).  The inverse by block forward
    substitution, X_kk = L_kk^-1, X_i,:i = -L_ii^-1 (L_i,:i X_:i,:i), taken
    a whole block row per product (2 products per row instead of one per
    block pair): the driver's time on the card is launches, not
    arithmetic."""
    P = _panel('chol_inv_batched', A, PANEL)
    M = A.shape[-1]
    if M == P:
        return chol_inv_base(A.contiguous())
    L, Dinv = _factor_lower(A, P)
    X = torch.zeros_like(A)
    for k, Dk in enumerate(Dinv):
        X[:, k * P:(k + 1) * P, k * P:(k + 1) * P] = Dk
    for i in range(1, M // P):
        s = i * P
        X[:, s:s + P, :s] = -(Dinv[i] @ (L[:, s:s + P, :s] @ X[:, :s, :s]))
    return L, X


def chol_factor_batched(A: torch.Tensor, panel: int = 128) -> torch.Tensor:
    """Factor-only blocked Cholesky: A [B, M, M] SPD -> L lower with
    L L^T = A -- the factor phase of :func:`chol_inv_batched` without the
    block inverse, for callers that build the inverse another way (the
    M > 512 route of ``linalg._chol_inv_impl`` pairs it with
    :func:`tri_inv_doubling`)."""
    P = _panel('chol_factor_batched', A, panel)
    if A.shape[-1] == P:
        return chol_inv_base(A.contiguous())[0]
    return _factor_lower(A, P)[0]


# ------------------------------------------------------------------- K2


def chol_inv_base_upper_plain(D: torch.Tensor):
    """Plain PyTorch version of K2, step for step: the elimination of
    :func:`chol_inv_base_plain` run from the bottom-right corner, so the
    factor comes out upper (R R^T = D)."""
    b, P, _ = D.shape
    eye = torch.eye(P, dtype=D.dtype, device=D.device).expand(b, P, P)
    W = torch.cat([D, eye], dim=2).clone()
    R = torch.zeros_like(D)
    Rinv = torch.empty_like(D)
    for j in range(P - 1, -1, -1):
        rowj = W[:, j:j + 1, :]                              # [b, 1, 2P]
        rsq = torch.rsqrt(rowj[:, :, j:j + 1])               # [b, 1, 1]
        Rinv[:, j:j + 1, :] = rowj[:, :, P:] * rsq
        cvec = W[:, :j + 1, j:j + 1] * rsq                   # [b, j+1, 1]
        R[:, :j + 1, j:j + 1] = cvec
        if j > 0:
            W[:, :j, :] -= (cvec[:, :j] * rsq) * rowj
    return R, Rinv


def chol_inv_base_upper(D: torch.Tensor):
    """[b, P, P] symmetric -> (R, R^-1) with R upper, R R^T = D; like K1 it
    reads both triangles of D.

    A CUDA tensor launches K2 (float32, contiguous, P <= 128) or raises; a
    CPU tensor takes :func:`chol_inv_base_upper_plain`."""
    if _check_device('chol_inv_base_upper', D):
        return chol_inv_base_upper_plain(D)
    R, Rinv = _launch('chol_inv', 'chol_inv_base_upper', D, 2)
    chol_inv_base_upper.launches += 1
    return R, Rinv


chol_inv_base_upper.launches = 0


def sym_from_tril(D: torch.Tensor) -> torch.Tensor:
    """The symmetric matrix of D's lower triangle, tril(D) + tril(D, -1)^T:
    equal to D when D is symmetric, and it makes the upper drivers below
    read only the lower triangle of their input."""
    return torch.tril(D) + _T(torch.tril(D, -1))


def _factor_blocks_upper(A: torch.Tensor, P: int):
    """Upper mirror of :func:`_factor_lower`, from the bottom-right corner:

        R_kk, R_kk^-1 = base(sym(rem_kk));  R_12 = A_21^T R_kk^-T;
        rem <- rem_11 - R_12 R_12^T.

    Returns ({(i, k): block of R, i <= k}, {k: R_kk^-1}, {k: the unsplit
    [B, kP, P] panel above diagonal block k}).  Reads only the lower
    triangle of A: panel solves take the lower block row A_21, diagonal
    blocks are symmetrized from their lower triangle."""
    n = A.shape[-1] // P
    Rb, Dinv, Rcols = {}, {}, {}
    rem = A
    for k in range(n - 1, 0, -1):
        Rkk, Rkkinv = chol_inv_base_upper(sym_from_tril(rem[:, -P:, -P:]))
        Rb[(k, k)] = Rkk
        Dinv[k] = Rkkinv
        R12 = _T(rem[:, -P:, :-P]) @ _T(Rkkinv)              # [B, kP, P]
        rem = rem[:, :-P, :-P] - R12 @ _T(R12)
        Rcols[k] = R12
        for i in range(k):
            Rb[(i, k)] = R12[:, i * P:(i + 1) * P]
    Rb[(0, 0)], Dinv[0] = chol_inv_base_upper(sym_from_tril(rem))
    return Rb, Dinv, Rcols


def chol_inv_batched_upper(A: torch.Tensor, panel: int = PANEL):
    """Upper mirror of :func:`chol_inv_batched`: A [B, M, M] SPD (lower
    triangle read) -> (R, R^-1) with R upper, R R^T = A.  The inverse by
    block back substitution, a block row per product pair from the bottom:
    X_kk = R_kk^-1,  X_i,i+1: = -R_ii^-1 (R_i,i+1: X_i+1:,i+1:)."""
    P = _panel('chol_inv_batched_upper', A, panel)
    M = A.shape[-1]
    if M == P:
        return chol_inv_base_upper(sym_from_tril(A))
    Rb, Dinv, _ = _factor_blocks_upper(A, P)
    n = M // P
    R = torch.zeros_like(A)
    X = torch.zeros_like(A)
    for (i, k), blk in Rb.items():
        R[:, i * P:(i + 1) * P, k * P:(k + 1) * P] = blk
    for k in range(n):
        X[:, k * P:(k + 1) * P, k * P:(k + 1) * P] = Dinv[k]
    for i in range(n - 2, -1, -1):
        s, e = i * P, (i + 1) * P
        X[:, s:e, e:] = -(Dinv[i] @ (R[:, s:e, e:] @ X[:, e:, e:]))
    return R, X


def chol_right_solve_upper(A: torch.Tensor, X: torch.Tensor,
                           panel: int = PANEL) -> torch.Tensor:
    """A [B, M, M] SPD (lower triangle read), X [B, N, M] -> Y = X R^-T
    where R is the upper factor (R R^T = A), without forming R^-1: block
    back substitution on Y R^T = X in right-looking form, at step
    k = n-1 .. 0

        Y_k = rem_k R_kk^-T;   rem <- rem[:, :, :-P] - Y_k Rcol_k^T

    with Rcol_k the unsplit panel of :func:`_factor_blocks_upper`: 2n
    products in all."""
    P = _panel('chol_right_solve_upper', A, panel)
    if A.shape[-1] == P:
        _, Dinv0 = chol_inv_base_upper(sym_from_tril(A))
        return X @ _T(Dinv0)
    _, Dinv, Rcols = _factor_blocks_upper(A, P)
    n = A.shape[-1] // P
    Y = [None] * n
    rem = X
    for k in range(n - 1, 0, -1):
        Y[k] = rem[:, :, -P:] @ _T(Dinv[k])
        rem = rem[:, :, :-P] - Y[k] @ _T(Rcols[k])
    Y[0] = rem @ _T(Dinv[0])
    return torch.cat(Y, dim=2)


# ------------------------------------------------------------------- K3


def tri_inv_base_plain(L: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3, as the JAX kernel computes it: forward
    substitution a row at a time over the whole batch,
    X[i, :] = (e_i - sum_{p<i} L[i, p] X[p, :]) / L[i, i]."""
    b, P, _ = L.shape
    X = torch.zeros_like(L)
    eye = torch.eye(P, dtype=L.dtype, device=L.device)
    for i in range(P):
        contrib = (L[:, i, :i, None] * X[:, :i, :]).sum(1, keepdim=True)
        X[:, i:i + 1, :] = (eye[i] - contrib) / L[:, i:i + 1, i:i + 1]
    return X


def tri_inv_base(L: torch.Tensor) -> torch.Tensor:
    """[b, P, P] lower-triangular -> L^-1 (the strict upper triangle of L
    is not read).

    A CUDA tensor launches K3 (float32, contiguous, P <= 128, P % 4 == 0)
    or raises; a CPU tensor takes :func:`tri_inv_base_plain`."""
    if _check_device('tri_inv_base', L, multiple=4):
        return tri_inv_base_plain(L)
    X, = _launch('tri_inv', 'tri_inv_base', L, 1)
    tri_inv_base.launches += 1
    return X


tri_inv_base.launches = 0


def tri_inv_doubling(L: torch.Tensor, block: int = 128) -> torch.Tensor:
    """L [..., M, M] lower-triangular -> L^-1 by recursive block doubling,

        inv([[A, 0], [B, C]]) = [[A^-1, 0], [-C^-1 B A^-1, C^-1]]:

    the M/block diagonal blocks invert together in one K3 launch, then
    log2(M/block) levels of batched products merge pairs.  Needs
    M % block == 0 and M/block a power of two."""
    *batch, M, M2 = L.shape
    nb = M // block
    if M != M2 or M % block or nb & (nb - 1):
        raise ValueError(f'tri_inv_doubling: {tuple(L.shape)} with block {block}')
    Lf = L.reshape(-1, M, M)
    Bn = Lf.shape[0]
    dblocks = torch.stack(
        [Lf[:, k * block:(k + 1) * block, k * block:(k + 1) * block]
         for k in range(nb)], dim=1).reshape(Bn * nb, block, block)
    invs = list(tri_inv_base(dblocks).reshape(Bn, nb, block, block).unbind(1))
    s = block
    while s < M:
        pairs = len(invs) // 2
        Ainv = torch.stack(invs[0::2], dim=1)              # [Bn, pairs, s, s]
        Cinv = torch.stack(invs[1::2], dim=1)
        Bblk = torch.stack(
            [Lf[:, (2 * p + 1) * s:(2 * p + 2) * s, 2 * p * s:(2 * p + 1) * s]
             for p in range(pairs)], dim=1)
        X21 = -(Cinv @ (Bblk @ Ainv))
        merged = torch.cat([torch.cat([Ainv, torch.zeros_like(X21)], dim=-1),
                            torch.cat([X21, Cinv], dim=-1)], dim=-2)
        invs = list(merged.unbind(1))
        s *= 2
    return invs[0].reshape(*batch, M, M)
