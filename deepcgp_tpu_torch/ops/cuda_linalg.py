"""Batched Cholesky factors, their inverses and triangular inverses: the
CUDA kernels and the drivers named after the JAX package's.

Counterpart of ``deepcgp_tpu/ops/pallas_linalg.py``.  Three kernels:

* K1 (``csrc/chol_inv.cu``, :func:`chol_factor_blocked`): the whole
  blocked lower Cholesky factor of a [B, M, M] batch (M % 32 == 0,
  M <= 1024) in one launch, one thread-block cluster a matrix, with the
  inverses of its 32x32 diagonal blocks;
* K2 (``csrc/chol_inv.cu``, :func:`chol_upper_blocked`): the same for the
  index-reversed matrix, read from the lower triangle of G [B, M, M]
  (M % 32 == 0, M <= 2048): Lf = chol(J G J), J the index reversal, so
  R = J Lf J is G's upper factor (R R^T = G), with its panel spread over
  the cluster's shared memory (:func:`upper_plan`);
* K3 (``csrc/tri_inv.cu``, :func:`tri_inv_blocked`): the inverse of a
  [B, M, M] lower triangle (M <= 2048) in one launch, by independent
  column strips, taking K1's or K2's diagonal-block inverses where it has
  them.

The JAX package's names keep their signatures: :func:`chol_inv_base` and
:func:`chol_inv_batched` run K1 then K3, :func:`chol_factor_batched` K1,
:func:`tri_inv_base` and :func:`tri_inv_doubling` K3, and
:func:`chol_inv_base_upper` K2 then K3 -- no Python panel loop on the
card.  The upper drivers :func:`chol_inv_batched_upper` and
:func:`chol_right_solve_upper` take the route :func:`upper_route` gives
M: K2 then K3 and one product up to M = 2048, and above it the panel
drivers around :func:`chol_inv_base_upper`.  On a CPU tensor each kernel
wrapper runs its plain version, which follows the kernel's block order
step for step.  The panel drivers' panel solves, trailing downdates and
block substitutions are full-f32 matrix products (TF32 is off, see
``config``).

A non-PD batch element gives NaN in its factor and inverse and leaves the
others untouched, as ``torch.linalg.cholesky`` in JAX's NaN convention
would: callers detect a failed factorization by finiteness.
"""

from __future__ import annotations

import ctypes

import torch

from deepcgp_tpu_torch.ops import cuda_build
from deepcgp_tpu_torch.utils import profiling

# The JAX package's panel (the NatGrad drivers' contract).
PANEL = 64
# K1's panel width and K3's diagonal blocks (one warp, one lane a row), and
# the largest matrix K1 takes (it stages a [M - 32, 32] panel in each
# block's shared memory: 140 KB at 1024).
W = 32
MAX_M = 1024
# The largest matrix K2 and K3 take (K2 spreads its panel over the
# cluster, :func:`upper_plan`; K3's strip of X takes 8 M floats).
UPPER_MAX_M = 2048
# A block's opt-in shared memory on the card, and a staged 32x32 tile
# (rows of 36 floats) in bytes.
SMEM_BYTES = 232_448
TILE_BYTES = 4 * W * 36
_SUB = 8          # the diagonal factor's column blocks


def _T(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _check_device(what: str, A: torch.Tensor, multiple: int,
                  largest: int) -> bool:
    """True for a CPU tensor (the plain version runs); for a CUDA tensor,
    raise on anything the kernel does not take and return False."""
    if A.device.type == 'cpu':
        return True
    if A.device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {A.device}')
    if A.dtype != torch.float32:
        raise TypeError(f'{what}: float32 only, got {A.dtype}')
    if (A.ndim != 3 or A.shape[1] != A.shape[2] or A.shape[0] == 0
            or not 0 < A.shape[1] <= largest or A.shape[1] % multiple):
        raise ValueError(f'{what}: need [b, P, P] with P <= {largest}'
                         f'{f" and P % {multiple} == 0" if multiple > 1 else ""},'
                         f' got {tuple(A.shape)}')
    if not A.is_contiguous():
        raise ValueError(f'{what}: input must be contiguous')
    return False


def _width(M: int) -> int:
    """The plain versions' block width: K1's W, or the whole matrix where
    it is not a multiple of W (the CPU takes any M; the card raises)."""
    return W if M % W == 0 else M


# ------------------------------------------------------------------- K1


def _factor_tile_plain(D: torch.Tensor) -> torch.Tensor:
    """The factor of one diagonal tile as K1's warp computes it: the
    columns in blocks of 8, each eliminated step by step (pivot W[j][j],
    rsq = rsqrt(pivot), column j of L = W[j:, j] * rsq, rows i > j update
    the block's columns k > j by (W[i][j] * rsq) * rsq * W[j][k]), then
    folded into the columns right of it by one rank-8 update.  The 8x8
    diagonal sub-blocks are read whole (both triangles)."""
    b, P, _ = D.shape
    Wt = D.clone()
    for b0 in range(0, P, _SUB):
        e = min(b0 + _SUB, P)
        for j in range(b0, e):
            rsq = torch.rsqrt(Wt[:, j, j])[:, None]               # [b, 1]
            m = (Wt[:, j + 1:, j] * rsq) * rsq                    # [b, P-j-1]
            Wt[:, j + 1:, j + 1:e] -= m[:, :, None] * Wt[:, j:j + 1, j + 1:e]
            Wt[:, j:, j] *= rsq
            Wt[:, :j, j] = 0
        if e < P:
            Lb = Wt[:, e:, b0:e]
            Wt[:, e:, e:] -= Lb @ _T(Lb)
    return torch.tril(Wt)


def _forward_sub_plain(Lii: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Lii^-1 R for lower Lii [B, w, w], column by column as K3's warps and
    K1's inverse warps run it: y_q *= 1 / L_qq, then r_s -= L_sq y_q for
    s > q."""
    Y = R.clone()
    for q in range(Lii.shape[-1]):
        Y[:, q] = Y[:, q] * (1 / Lii[:, q, q, None])
        Y[:, q + 1:] -= Lii[:, q + 1:, q, None] * Y[:, q:q + 1]
    return Y


def _right_solve_plain(Wt: torch.Tensor, Lkk: torch.Tensor) -> torch.Tensor:
    """Wt Lkk^-T for Wt [B, m, w], a row per lane as K1's panel solve runs
    it: x_q = w_q * (1 / L_qq), then w_q' -= L_q'q x_q for q' > q."""
    X = Wt.clone()
    for q in range(Lkk.shape[-1]):
        X[:, :, q] = X[:, :, q] * (1 / Lkk[:, q, q, None])
        X[:, :, q + 1:] -= X[:, :, q:q + 1] * Lkk[:, None, q + 1:, q]
    return X


def tri_inv_base_plain(L: torch.Tensor) -> torch.Tensor:
    """The inverse of lower [b, P, P] by forward substitution on the
    identity: the plain version of :func:`tri_inv_base` at M = P <= 32,
    and of the diagonal-block inverses K1 writes."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return _forward_sub_plain(L, eye.expand(L.shape))


def chol_inv_base_plain(D: torch.Tensor):
    """The factor and its inverse of one [b, P, P] block, as K1 computes
    them for each diagonal tile: the plain version of :func:`chol_inv_base`
    at M = P <= 32."""
    L = _factor_tile_plain(D)
    return L, tri_inv_base_plain(L)


def _right_looking_plain(A: torch.Tensor, w: int | None = None):
    """K1's block order: the right-looking factor of A [B, M, M] in w-wide
    panels (w = W by default),

        L_kk, L_kk^-1 = chol_inv_base_plain(rem_kk);
        L_21 = rem_21 L_kk^-T (forward substitution on L_kk);
        rem <- rem_22 - L_21 L_21^T.

    Returns (L, Dinv) with Dinv [B, M/w, w, w] the diagonal blocks'
    inverses."""
    B, M, _ = A.shape
    w = w or _width(M)
    if M % w:
        raise ValueError(f'chol_factor_blocked_plain: M = {M}, w = {w}')
    L = torch.zeros_like(A)
    Dinv = A.new_empty(B, M // w, w, w)
    rem = A
    for k in range(M // w):
        s = k * w
        Lkk, Dinv[:, k] = chol_inv_base_plain(rem[:, :w, :w])
        L[:, s:s + w, s:s + w] = Lkk
        if s + w < M:
            L21 = _right_solve_plain(rem[:, w:, :w], Lkk)    # [B, m, w]
            L[:, s + w:, s:s + w] = L21
            rem = rem[:, w:, w:] - L21 @ _T(L21)
    return L, Dinv


def chol_factor_blocked_plain(A: torch.Tensor, w: int | None = None):
    """Plain PyTorch version of K1, in its block order
    (:func:`_right_looking_plain`): (L, Dinv) of A [B, M, M]."""
    return _right_looking_plain(A, w)


_MAX_CLUSTERS: dict = {}


def _max_clusters(M: int, cluster: int,
                  symbol: str = 'chol_factor_max_clusters') -> int:
    """How many ``cluster``-block clusters of K1 (or of K2, ``symbol``
    ``chol_upper_max_clusters``) at M the current card holds at once,
    asked once per device."""
    key = (torch.cuda.current_device(), symbol, M, cluster)
    if key not in _MAX_CLUSTERS:
        fn = cuda_build.function('chol_inv', symbol, [ctypes.c_int] * 2)
        _MAX_CLUSTERS[key] = fn(M, cluster)
    return _MAX_CLUSTERS[key]


def _cluster(M: int, B: int = 1) -> int:
    """K1's blocks per matrix: 16 (non-portable) from M = 512 up, where a
    matrix has enough tiles to share, else 8; halved, down to 4, while the
    card cannot hold all B clusters at once, so a batch runs in one wave
    (the NatGrad solve's [20, 384, 384] and [10, 1024, 1024]).  The Kuu
    shapes ([3, 384, 384], [1, 1024, 1024]) fit at the first size."""
    cluster = 16 if M >= 512 else 8
    while cluster > 4 and B > _max_clusters(M, cluster):
        cluster //= 2
    return cluster


def chol_factor_blocked(A: torch.Tensor):
    """K1: A [B, M, M] SPD -> (L, Dinv), L lower with L L^T = A and Dinv
    [B, M/32, 32, 32] the inverses of its diagonal blocks.

    A CUDA tensor (float32, contiguous, M % 32 == 0, M <= 1024) launches
    the kernel, one thread-block cluster a matrix, or raises; a CPU tensor
    takes :func:`chol_factor_blocked_plain`.  Launches count on
    ``chol_inv_base.launches``."""
    if _check_device('chol_factor_blocked', A, W, MAX_M):
        return chol_factor_blocked_plain(A)
    B, M, _ = A.shape
    L = torch.empty_like(A)
    Dinv = A.new_empty(B, M // W, W, W)
    fn = cuda_build.function(
        'chol_inv', 'chol_factor_blocked',
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with profiling.launch('chol_factor_blocked', (A,), (L, Dinv)):
        cuda_build.check(fn(A.data_ptr(), L.data_ptr(), Dinv.data_ptr(), B,
                            M, _cluster(M, B), stream), 'chol_factor_blocked')
    chol_inv_base.launches += 1
    return L, Dinv


def chol_inv_base(D: torch.Tensor):
    """[b, M, M] symmetric -> (chol(D), chol(D)^-1), L lower: K1 then K3
    (:func:`chol_factor_blocked`, :func:`tri_inv_blocked` with K1's
    diagonal-block inverses), two launches.  The 8x8 sub-blocks on the
    diagonal are read whole (both triangles), as the JAX base kernel reads
    its whole input, the rest on and below the diagonal.

    ``chol_inv_base.launches`` counts K1's launches."""
    L, Dinv = chol_factor_blocked(D)
    return L, tri_inv_blocked(L, Dinv)


chol_inv_base.launches = 0


def _panel(what: str, A: torch.Tensor, panel: int) -> int:
    """The JAX drivers' shape contract, [B, M, M] with M a multiple of
    P = min(panel, M); returns P."""
    B, M, M2 = A.shape
    P = min(panel, M)
    if M != M2 or M % P:
        raise ValueError(f'{what}: {tuple(A.shape)} with panel {P}')
    return P


def chol_inv_batched(A: torch.Tensor):
    """Blocked Cholesky of a batch of SPD matrices with the explicit
    inverse of the factor: A [B, M, M] -> (L, L^-1), as
    :func:`chol_inv_base` (K1 then K3: two launches whatever M)."""
    _panel('chol_inv_batched', A, PANEL)
    return chol_inv_base(A.contiguous())


def chol_factor_batched(A: torch.Tensor, panel: int = 128) -> torch.Tensor:
    """Factor-only blocked Cholesky: A [B, M, M] SPD -> L lower with
    L L^T = A, one K1 launch.  ``panel`` keeps the JAX driver's shape
    contract (M a multiple of min(panel, M)); the kernel's own panel is
    W."""
    _panel('chol_factor_batched', A, panel)
    return chol_factor_blocked(A.contiguous())[0]


# ------------------------------------------------------------------- K2


def upper_plan(M: int, cluster: int) -> dict:
    """K2's split of one [M, M] matrix over a cluster of ``cluster``
    blocks, as the kernel follows it: tile row 0 (the first diagonal tile)
    belongs to the first block, which runs the chain of diagonal tiles;
    tile row i >= 1 to worker ``owner[i] = 1 + (i - 1) % (cluster - 1)``,
    at ``slot[i]`` of its panel buffers.  The owner downdates every tile
    of its rows and keeps their panel tiles in its shared memory, two
    buffers of ``rows`` tiles (panel k in buffer k % 2); each warp has two
    tiles more (a tile in flight and a copy of a peer's panel row), and
    the block L_dd^T: ``smem_bytes`` of dynamic shared memory a block."""
    n, nw = M // W, cluster - 1
    rows = -(-(n - 1) // nw)
    return {'owner': [0] + [1 + (i - 1) % nw for i in range(1, n)],
            'slot': [0] + [(i - 1) // nw for i in range(1, n)],
            'rows': rows,
            'smem_bytes': TILE_BYTES * (2 * rows + 2 * 8 + 1)}


def upper_clusters(M: int) -> list:
    """The cluster sizes K2's launcher may take at M, in the order it
    tries them (:func:`_upper_cluster`): K1's, 16 from M = 512 up, else 8,
    halved down to 4, keeping those whose shared memory fits a block."""
    first = 16 if M >= 512 else 8
    return [c for c in (16, 8, 4) if c <= first
            and upper_plan(M, c)['smem_bytes'] <= SMEM_BYTES]


def _upper_cluster(M: int, B: int = 1) -> int:
    """K2's blocks per matrix: the first of :func:`upper_clusters` at
    which the card holds all B clusters at once, else the last (the batch
    then runs in waves)."""
    sizes = upper_clusters(M)
    for cluster in sizes[:-1]:
        if B <= _max_clusters(M, cluster, 'chol_upper_max_clusters'):
            return cluster
    return sizes[-1]


_LOWER_MASKS: dict = {}


def reversed_sym_from_tril(A: torch.Tensor) -> torch.Tensor:
    """J sym(A) J, J the index reversal and sym(A) = tril(A) +
    tril(A, -1)^T, from A's lower triangle only: with Af = J A J (whose
    upper triangle is A's lower one), Gr = where(i >= j, Af^T, Af).  Two
    passes over [B, M, M] (the flip and the select), and symmetric, as K1
    needs for its diagonal sub-blocks."""
    M = A.shape[-1]
    key = (M, A.device)
    mask = _LOWER_MASKS.get(key)
    if mask is None:
        mask = torch.ones(M, M, dtype=torch.bool, device=A.device).tril()
        _LOWER_MASKS[key] = mask
    Af = A.flip(-1, -2)
    return torch.where(mask, _T(Af), Af)


def chol_upper_blocked_plain(A: torch.Tensor, w: int | None = None):
    """Plain PyTorch version of K2: K1's block order
    (:func:`_right_looking_plain`) on J A J built from A's lower
    triangle alone (:func:`reversed_sym_from_tril`), the arithmetic K2 runs
    on its reversed reads.  Returns (Lf, Dinv), Lf = chol(J A J) lower."""
    return _right_looking_plain(reversed_sym_from_tril(A), w)


def chol_upper_blocked(A: torch.Tensor):
    """K2: A [B, M, M] SPD, lower triangle read -> (Lf, Dinv), Lf lower
    with Lf Lf^T = J A J (J the index reversal: R = J Lf J is A's upper
    factor, R R^T = A) and Dinv [B, M/32, 32, 32] the inverses of Lf's
    diagonal blocks, K1's layout (K3 takes both).

    A CUDA tensor (float32, contiguous, M % 32 == 0, M <= 2048) launches
    the kernel, one thread-block cluster a matrix, or raises; a CPU tensor
    takes :func:`chol_upper_blocked_plain`.  Launches count on
    ``chol_inv_base_upper.launches``."""
    if _check_device('chol_upper_blocked', A, W, UPPER_MAX_M):
        return chol_upper_blocked_plain(A)
    B, M, _ = A.shape
    L = torch.empty_like(A)
    Dinv = A.new_empty(B, M // W, W, W)
    fn = cuda_build.function(
        'chol_inv', 'chol_upper_blocked',
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(A.device).cuda_stream
    # K2 reads G's lower triangle only.
    with profiling.launch('chol_upper_blocked',
                          (A.element_size() * B * M * (M + 1) // 2,),
                          (L, Dinv)):
        cuda_build.check(fn(A.data_ptr(), L.data_ptr(), Dinv.data_ptr(), B,
                            M, _upper_cluster(M, B), stream),
                         'chol_upper_blocked')
    chol_inv_base_upper.launches += 1
    return L, Dinv


def chol_inv_base_upper_padded(D: torch.Tensor):
    """:func:`chol_inv_base_upper` of a block whose P is not a multiple of
    32, through an identity tail: D is padded to the next multiple of 32
    as blockdiag(D, I), whose upper factor is blockdiag(R, I) and its
    inverse blockdiag(R^-1, I), so the leading [P, P] corners of the
    padded results are R and R^-1.  K2 factors the padded tail first (J
    reverses it to the top) and its panels below are zeros, so nothing
    of the tail reaches D's part but exact zeros.  The card takes this
    route for such a P; on the CPU it runs the same plain versions K2 and
    K3 follow."""
    b, P, _ = D.shape
    Pp = -(-P // W) * W
    padded = torch.eye(Pp, dtype=D.dtype, device=D.device).repeat(b, 1, 1)
    padded[:, :P, :P] = D
    R, Rinv = chol_inv_base_upper(padded)
    return R[:, :P, :P], Rinv[:, :P, :P]


def chol_inv_base_upper(D: torch.Tensor):
    """[b, P, P] SPD, lower triangle read -> (R, R^-1) with R upper,
    R R^T = D: K2 then K3 (:func:`chol_upper_blocked`,
    :func:`tri_inv_blocked` with K2's diagonal-block inverses), two
    launches, R = J Lf J and R^-1 = J Lf^-1 J.  K2 and K3 take a P that
    is a multiple of 32 up to 2048, as K1 does (:func:`chol_inv_base`);
    on the card any other P up to 2048 takes
    :func:`chol_inv_base_upper_padded`, the same two launches on the block
    padded with an identity tail, so that, as the JAX package's upper base
    case, it takes any P.

    ``chol_inv_base_upper.launches`` counts K2's launches."""
    if D.device.type == 'cuda' and D.ndim == 3 and D.shape[-1] % W:
        return chol_inv_base_upper_padded(D)
    Lf, Dinv = chol_upper_blocked(D)
    return Lf.flip(-1, -2), tri_inv_blocked(Lf, Dinv).flip(-1, -2)


chol_inv_base_upper.launches = 0


def _factor_blocks_upper(A: torch.Tensor, P: int):
    """Upper mirror of :func:`chol_factor_blocked_plain`, from the
    bottom-right corner, in P-wide panels around
    :func:`chol_inv_base_upper`:

        R_kk, R_kk^-1 = base(rem_kk);  R_12 = A_21^T R_kk^-T;
        rem <- rem_11 - R_12 R_12^T.

    Returns ({(i, k): block of R, i <= k}, {k: R_kk^-1}, {k: the unsplit
    [B, kP, P] panel above diagonal block k}).  Reads only the lower
    triangle of A: the base reads the lower triangle of its block, the
    panel solves the lower block row A_21."""
    n = A.shape[-1] // P
    Rb, Dinv, Rcols = {}, {}, {}
    rem = A
    for k in range(n - 1, 0, -1):
        Rkk, Rkkinv = chol_inv_base_upper(rem[:, -P:, -P:].contiguous())
        Rb[(k, k)] = Rkk
        Dinv[k] = Rkkinv
        R12 = _T(rem[:, -P:, :-P]) @ _T(Rkkinv)              # [B, kP, P]
        rem = rem[:, :-P, :-P] - R12 @ _T(R12)
        Rcols[k] = R12
        for i in range(k):
            Rb[(i, k)] = R12[:, i * P:(i + 1) * P]
    Rb[(0, 0)], Dinv[0] = chol_inv_base_upper(rem.contiguous())
    return Rb, Dinv, Rcols


def chol_inv_batched_upper_panels(A: torch.Tensor, panel: int = PANEL):
    """The panel driver of :func:`chol_inv_batched_upper`, for any M that
    is a multiple of P = min(panel, M): A [B, M, M] SPD (lower triangle
    read) -> (R, R^-1).  The inverse by block back substitution, a block
    row per product pair from the bottom:
    X_kk = R_kk^-1,  X_i,i+1: = -R_ii^-1 (R_i,i+1: X_i+1:,i+1:)."""
    P = _panel('chol_inv_batched_upper', A, panel)
    M = A.shape[-1]
    if M == P:
        return chol_inv_base_upper(A.contiguous())
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


def chol_right_solve_upper_panels(A: torch.Tensor, X: torch.Tensor,
                                  panel: int = PANEL) -> torch.Tensor:
    """The panel driver of :func:`chol_right_solve_upper`: A [B, M, M]
    SPD (lower triangle read), X [B, N, M] -> Y = X R^-T, R the upper
    factor (R R^T = A), without forming R^-1: block back substitution on
    Y R^T = X in right-looking form, at step k = n-1 .. 0

        Y_k = rem_k R_kk^-T;   rem <- rem[:, :, :-P] - Y_k Rcol_k^T

    with Rcol_k the unsplit panel of :func:`_factor_blocks_upper`: n calls
    of :func:`chol_inv_base_upper` and 2n products in all."""
    P = _panel('chol_right_solve_upper', A, panel)
    if A.shape[-1] == P:
        _, Dinv0 = chol_inv_base_upper(A.contiguous())
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


def upper_route(M: int):
    """How the upper drivers take [B, M, M], by shape alone (the same on the
    CPU and the card): ('upper', None) -- K2 then K3 and one product,
    :func:`chol_right_solve_reversed` -- for M % 32 == 0 up to 2048 (at
    M <= 1024 it is no slower than K1 on J G J built first, PERF.md);
    ('panels', P) -- the panel driver around
    :func:`chol_inv_base_upper`, P the largest power of two up to 2048
    that divides M -- for the multiples of 64 above 2048; None for the
    rest, where the drivers keep the JAX package's shape contract (M a
    multiple of min(panel, M)) and raise outside it."""
    if M % W == 0 and M <= UPPER_MAX_M:
        return 'upper', None
    if M % 64 or M < UPPER_MAX_M:
        return None
    P = UPPER_MAX_M
    while M % P:
        P //= 2
    return 'panels', P


def chol_inv_reversed_upper(A: torch.Tensor):
    """A [B, M, M] SPD (lower triangle read) -> (Lf, Lf^-1) with
    Lf = chol(J A J): R = J Lf J is upper with R R^T = A, and J Lf^-1 J is
    its inverse.  K2 then K3: two launches on the card, the plain versions
    on the CPU.  Unreversed: callers fold the reversal into what they do
    next."""
    Lf, Dinv = chol_upper_blocked(A)
    return Lf, tri_inv_blocked(Lf, Dinv)


def chol_right_solve_reversed(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """A [B, M, M] SPD (lower triangle read), X [B, N, M] -> Y = X R^-T,
    R the upper factor of A, as Y = X (J Lf^-1 J)^T: K2 and K3
    (:func:`chol_inv_reversed_upper`), one [B, M, M] flip of Lf^-1 and one
    batched product -- no Python panel loop."""
    _, Lfinv = chol_inv_reversed_upper(A)
    return X @ _T(Lfinv.flip(-1, -2))


def chol_inv_batched_upper(A: torch.Tensor, panel: int | None = None):
    """Upper mirror of :func:`chol_inv_batched`: A [B, M, M] SPD (lower
    triangle read) -> (R, R^-1) with R upper, R R^T = A, by the route of
    :func:`upper_route`: R = J Lf J and R^-1 = J Lf^-1 J from
    :func:`chol_inv_reversed_upper` (two launches), or the panel driver
    :func:`chol_inv_batched_upper_panels` at ``panel`` (default: the
    route's own, else 64).  On the card the panel driver's base case is
    :func:`chol_inv_base_upper`, which takes a block that is not a
    multiple of 32 (M = 48, say) through its identity padding."""
    kind, P = upper_route(A.shape[-1]) or ('panels', PANEL)
    if kind == 'upper':
        Lf, Lfinv = chol_inv_reversed_upper(A.contiguous())
        return Lf.flip(-1, -2), Lfinv.flip(-1, -2)
    return chol_inv_batched_upper_panels(A, panel or P)


def chol_right_solve_upper(A: torch.Tensor, X: torch.Tensor,
                           panel: int | None = None) -> torch.Tensor:
    """A [B, M, M] SPD (lower triangle read), X [B, N, M] -> Y = X R^-T
    where R is the upper factor (R R^T = A), by the route of
    :func:`upper_route`: :func:`chol_right_solve_reversed`, or the panel
    driver :func:`chol_right_solve_upper_panels` at ``panel`` (default:
    the route's own, else 64).  As :func:`chol_inv_batched_upper`, a block
    that is not a multiple of 32 takes the base case's identity padding
    on the card."""
    kind, P = upper_route(A.shape[-1]) or ('panels', PANEL)
    if kind == 'upper':
        return chol_right_solve_reversed(A.contiguous(), X)
    return chol_right_solve_upper_panels(A, X, panel or P)


# ------------------------------------------------------------------- K3


def tri_inv_blocked_plain(L: torch.Tensor, Dinv: torch.Tensor | None = None,
                          w: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K3: L [B, M, M] lower -> L^-1 in w-wide
    blocks (w = W by default), each column block j independent of the
    others,

        X_jj = L_jj^-1,   X_ij = -L_ii^-1 sum_{j <= p < i} L_ip X_pj,

    taken a block row at a time for all column blocks at once (the same
    arithmetic per entry).  L_ii^-1 is ``Dinv[:, i]`` where given (K1's
    second output), else forward substitution on L_ii.  The strict upper
    triangle of L is not read."""
    B, M, _ = L.shape
    w = w or _width(M)
    if M % w:
        raise ValueError(f'tri_inv_blocked_plain: M = {M}, w = {w}')
    X = torch.zeros_like(L)
    eye = torch.eye(w, dtype=L.dtype, device=L.device).expand(B, w, w)
    for i in range(M // w):
        s = i * w
        R = torch.cat([-(L[:, s:s + w, :s] @ X[:, :s, :s]), eye], dim=2)
        X[:, s:s + w, :s + w] = (Dinv[:, i] @ R if Dinv is not None else
                                 _forward_sub_plain(L[:, s:s + w, s:s + w], R))
    return X


def tri_inv_blocked(L: torch.Tensor,
                    Dinv: torch.Tensor | None = None) -> torch.Tensor:
    """K3: L [B, M, M] lower-triangular -> L^-1 (the strict upper triangle
    of L is not read), with K1's or K2's diagonal-block inverses ``Dinv``
    [B, M/32, 32, 32] where given.

    A CUDA tensor (float32, contiguous, M % 32 == 0, M <= 2048) launches
    the kernel or raises; a CPU tensor takes :func:`tri_inv_blocked_plain`.
    Launches count on ``tri_inv_base.launches``."""
    if _check_device('tri_inv_blocked', L, W, UPPER_MAX_M):
        return tri_inv_blocked_plain(L, Dinv)
    B, M, _ = L.shape
    if Dinv is not None and (Dinv.shape != (B, M // W, W, W)
                             or Dinv.dtype != L.dtype
                             or Dinv.device != L.device
                             or not Dinv.is_contiguous()):
        raise ValueError(f'tri_inv_blocked: Dinv {tuple(Dinv.shape)} for L '
                         f'{tuple(L.shape)}')
    X = torch.empty_like(L)
    fn = cuda_build.function(
        'tri_inv', 'tri_inv_blocked',
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(L.device).cuda_stream
    with profiling.launch('tri_inv_blocked', (L, Dinv), (X,)):
        cuda_build.check(fn(L.data_ptr(),
                            None if Dinv is None else Dinv.data_ptr(),
                            X.data_ptr(), B, M, stream), 'tri_inv_blocked')
    tri_inv_base.launches += 1
    return X


def tri_inv_base(L: torch.Tensor) -> torch.Tensor:
    """[b, M, M] lower-triangular -> L^-1 (the strict upper triangle of L
    is not read): one K3 launch, which substitutes on the diagonal blocks.

    ``tri_inv_base.launches`` counts K3's launches."""
    return tri_inv_blocked(L.contiguous())


tri_inv_base.launches = 0


def tri_inv_doubling(L: torch.Tensor, block: int = 128) -> torch.Tensor:
    """L [..., M, M] lower-triangular -> L^-1, one K3 launch.  ``block``
    keeps the JAX driver's shape contract (M % block == 0 and M/block a
    power of two, as its block doubling needs); K3 itself takes the column
    strips of the whole matrix at once."""
    *batch, M, M2 = L.shape
    nb = M // block
    if M != M2 or M % block or nb & (nb - 1):
        raise ValueError(f'tri_inv_doubling: {tuple(L.shape)} with block {block}')
    return tri_inv_base(L.reshape(-1, M, M)).reshape(*batch, M, M)
