"""Fused patch extraction -> RBF cross-covariance of the last layer, and
its backward.

Counterpart of ``deepcgp_tpu/ops/pallas_cross.py``: (Kzx [N, M], Kdiag
[N]) of a patch-sum kernel with a scalar-lengthscale RBF base over a
FullView, straight from the images, in one launch of
``csrc/conv_rbf_cross.cu`` (K4); its gradients in two launches of
``csrc/conv_rbf_cross_bwd.cu`` (K5, image side and Z side).  The image
side has two designs, chosen by geometry (:func:`bwd_route`): one
thread-block cluster per image for P <= 64, and blocks over (image, row
tile, column tile) units for P > 64, with d images only when asked.  The
[N, P, L] patch tensor never reaches device memory; the backward keeps one
[N, P, M] intermediate there (see the source).
:func:`fused_conv_rbf_cross` is the ``torch.autograd.Function`` that ties
the two together, as JAX's custom VJP does: its forward saves only
(images, Z, variance, gamma, u, wkd).

K4 and K5's Z side run their products on the tensor cores in split TF32
(3xTF32): each float32 operand x is split into hi = tf32(x) and
lo = x - hi (which the tensor cores read truncated to TF32), and a
product takes hi*hi + hi*lo + lo*hi with float32 accumulation.
:func:`tf32_round`, :func:`matmul_3xtf32`, :func:`conv_rbf_cross_3xtf32`,
:func:`bwd_dz_3xtf32` and :func:`bwd_tiled_3xtf32` (the row-tiled image
side, unit by unit) emulate that scheme in plain PyTorch, for the tests;
nothing on a model's path calls them.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from deepcgp_tpu_torch.ops import cuda_build
from deepcgp_tpu_torch.ops.patches import extract_patches, out_size, pixel_index
from deepcgp_tpu_torch.utils import profiling

# Dynamic shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232448
# Inducing columns per tile of the backward's image side (kMT there).
_MT = 128
# The backward's image side: a cluster of blocks per image, one per column
# tile of M (at most a portable cluster's 8), each with one or two warps
# per 8 patch rows (P <= 64) and dpatches accumulators over at most 4
# column tiles of L.
BWD_MAX_P = 64
BWD_MAX_L = 4 * _MT
BWD_MAX_CLUSTER = 8
# The forward (K4): a block computes a tile of 128 (image, patch) rows by
# 128 inducing columns (or by the same 128 rows, for the Kdiag gram) over
# k-chunks of 16 patch elements; its shared memory is the same at every
# geometry (mirror of conv_rbf_cross_smem_bytes).
FWD_ROWS = 128
FWD_COLS = 128
_FWD_KC, _FWD_STAGES = 16, 3
FWD_SMEM = 4 * (_FWD_STAGES * FWD_ROWS * (_FWD_KC + 4)      # A, raw
                + _FWD_STAGES * FWD_COLS * _FWD_KC          # B, raw
                + 2 * FWD_COLS * (_FWD_KC + 4) * 2          # B, split
                + FWD_COLS + 2 * FWD_ROWS                   # norms, row sums
                + 4 * FWD_ROWS)                             # row tables
# The backward's image side for P > 64 (bwd_image_kernel_tiled): a block
# takes one unit -- (image, 128-row tile of patches, 128-column tile of M)
# or (image, pair a <= b of row tiles) of the Kdiag gram -- with K4's
# products and ring; its shared memory is the same at every geometry
# (mirror of conv_rbf_cross_bwd_tiled_smem_bytes).  With d images it forms
# dpatches 32 patch elements at a time.
TILED_ROWS = 128
TILED_X_COLS = 32
TILED_SMEM = 4 * (_FWD_STAGES * FWD_ROWS * (_FWD_KC + 4)    # A, raw
                  + _FWD_STAGES * FWD_COLS * _FWD_KC        # B, raw
                  + 2 * FWD_COLS * (_FWD_KC + 4) * 2        # B, split
                  + FWD_COLS + 4 * TILED_ROWS + 8 * FWD_COLS  # norms, sums
                  + 2 * TILED_ROWS + 16)                    # rows, scalars
# The backward's Z side: a block computes a tile of 128 inducing rows by 64
# patch elements over k-chunks of 16 (image, patch) rows; a cluster of
# blocks splits one tile's rows (mirror of conv_rbf_cross_bwd_z_smem_bytes).
Z_TILE_M = 128
Z_TILE_L = 64
Z_KC = 16
Z_MAX_CLUSTER = 16
Z_SMEM = 4 * (4 * Z_KC * Z_TILE_M                           # T: raw ring
              + 2 * Z_KC * (Z_TILE_M + 4) * 2               # T: split
              + 2 * Z_KC * (Z_TILE_L + 4) * 2               # patches: split
              + Z_TILE_M + 8 * Z_TILE_M + Z_TILE_L)         # colsums, offsets


def envelope_bytes(P: int, L: int) -> int:
    """The fused route's geometry envelope: the bytes of one image's patch
    matrix [L, Ppad] with its norm and reduction buffers, which must fit
    one block's shared memory (the rule the route has had since its first
    forward kernel, the counterpart of the JAX gate's VMEM check).  The
    tensor-core forward itself takes FWD_SMEM at every geometry."""
    Ppad = -(-P // 8) * 8
    warps = min(Ppad // 8, 8)
    return 4 * (L * Ppad + Ppad + _MT + warps * _MT)


def fwd_group(P: int) -> int:
    """Whole images a forward block takes: as many as fill its 128 rows
    (P <= 128), else one image in row tiles of 128."""
    return FWD_ROWS // P if P <= FWD_ROWS else 1


def fwd_gram_pairs(P: int) -> int:
    """Blocks of the forward's Kdiag gram per image group: one (P <= 128),
    else one per pair a <= b of the R = ceil(P / 128) row tiles, whose
    parts of Kdiag [N, R (R + 1) / 2] the wrapper sums."""
    R = -(-P // FWD_ROWS)
    return 1 if R == 1 else R * (R + 1) // 2


def fwd_grid(N: int, P: int, M: int, with_kdiag: bool) -> tuple:
    """(blocks along the images, blocks per image group) of a forward
    launch: one block per 128-column tile of M, plus the Kdiag gram's
    (:func:`fwd_gram_pairs`)."""
    return (-(-N // fwd_group(P)),
            -(-M // FWD_COLS) + (fwd_gram_pairs(P) if with_kdiag else 0))


def z_side_cluster(N: int, P: int, M: int, L: int, sms: int = 132) -> int:
    """Blocks of the backward's Z side that split one [128, 64] tile of dZ
    along the N P (image, patch) rows, as one thread-block cluster: enough
    to put two blocks on each SM, at most 16 (a non-portable cluster size
    above 8) and at most one per k-chunk of 16 rows."""
    tiles = (-(-M // _MT) * _MT // Z_TILE_M) * -(-L // Z_TILE_L)
    chunks = -(-N * P // Z_KC)
    return max(1, min(Z_MAX_CLUSTER, -(-2 * sms // tiles), chunks))


def bwd_smem_bytes(P: int, L: int) -> int:
    """Shared memory of one image-side backward block (mirror of
    ``conv_rbf_cross_bwd_image_smem_bytes``): the transposed patches, one
    column tile of T sharing its space with the block's part of dpatches,
    two 2048-float stages of Z, the gram's S on the rank's own pairs, and
    small buffers."""
    Ppad = -(-P // 8) * 8
    Lpad = -(-L // _MT) * _MT
    return 4 * (L * Ppad + max(_MT * Ppad, Ppad * Lpad) + 2 * 2048
                + Ppad * (Ppad + 1) + 8 * Ppad + 32)


def bwd_cluster(M: int) -> int:
    """Blocks a cluster of the image-side backward takes per image: one per
    128-column tile of M, at most BWD_MAX_CLUSTER (mirror of
    ``image_cluster`` in the source)."""
    return min(-(-M // _MT), BWD_MAX_CLUSTER)


def sum_bwd_partials(part: torch.Tensor, P: int):
    """The image side's partials part [N, S, 2P + 2] -- per image and
    cluster rank: du [P] (over the rank's columns of M), dwkd [P] (over
    its gram pairs), dvar, dgamma -- summed into (dvar, dgamma, du,
    dwkd)."""
    sums = part.reshape(-1, 2 * P + 2).sum(0)
    return sums[2 * P], sums[2 * P + 1], sums[:P], sums[P:2 * P]


def tiled_units(P: int, M: int, with_kdiag: bool) -> list:
    """The row-tiled image side's units in launch order (``blockIdx.x``):
    ('cross', row tile, column tile of M), row tile by row tile, then with
    Kdiag ('gram', a, b) for the row-tile pairs a <= b, row by row."""
    R, T = -(-P // TILED_ROWS), -(-M // _MT)
    units = [('cross', a, b) for a in range(R) for b in range(T)]
    if with_kdiag:
        units += [('gram', a, b) for a in range(R) for b in range(a, R)]
    return units


def tiled_plan(N: int, P: int, M: int, L: int, with_kdiag: bool,
               with_dimg: bool) -> dict:
    """The row-tiled image side's launch (mirror of
    ``conv_rbf_cross_bwd_image_tiled``): R row tiles of 128 patches, T
    column tiles of M, its grid (units, N), its shared memory, and the
    shapes of the partials it writes, a slot each unit: scalars [N, units,
    2], du [N, R, T, 128], dwkd [N, R, R, 128] (slot [a][b]: tile b's part
    of tile a's rows) and, with d images, dpatches' parts rx [N, R, slots,
    128, Lx] and their row sums rsum [N, R, slots, 128] (slots: T column
    tiles, then R gram partners)."""
    R, T = -(-P // TILED_ROWS), -(-M // _MT)
    units = len(tiled_units(P, M, with_kdiag))
    slots = T + (R if with_kdiag else 0)
    Lx = -(-L // TILED_X_COLS) * TILED_X_COLS
    return {'row_tiles': R, 'col_tiles': T, 'units': units,
            'grid': (units, N), 'smem': TILED_SMEM, 'slots': slots, 'Lx': Lx,
            'scalars': (N, units, 2), 'du': (N, R, T, TILED_ROWS),
            'dwkd': (N, R, R, TILED_ROWS) if with_kdiag else None,
            'rx': (N, R, slots, TILED_ROWS, Lx) if with_dimg else None,
            'rsum': (N, R, slots, TILED_ROWS) if with_dimg else None}


def sum_tiled_partials(sc, du, dwkd, P: int, variance):
    """The row-tiled image side's partials summed in a fixed order into
    (dvar, dgamma, du, dwkd): sc [N, units, 2] holds var dvar's and
    dgamma's terms, du and dwkd [N, R, slots, 128] a unit's part of a row
    tile's rows each (dwkd None without Kdiag)."""
    dvar = sc[..., 0].sum() / variance
    dgamma = sc[..., 1].sum()
    du = du.sum((0, 2)).reshape(-1)[:P]
    dwkd = (torch.zeros_like(du) if dwkd is None
            else dwkd.sum((0, 2)).reshape(-1)[:P])
    return dvar, dgamma, du, dwkd


def tiled_dimg(NHWC_X, rx, rsum, filter_size, stride=1, dilation=1):
    """Plain version of ``bwd_image_kernel_col2im``: dpatches = -2 (the
    slots of rx summed) + 2 patches (the slots of rsum summed), col2im'd
    into d images."""
    patches = extract_patches(NHWC_X, filter_size, stride, dilation)
    N, P, L = patches.shape
    rows = rx.shape[1] * TILED_ROWS
    dp = (-2.0 * rx.sum(2).reshape(N, rows, -1)[:, :P, :L]
          + 2.0 * patches * rsum.sum(2).reshape(N, rows)[:, :P, None])
    return col2im(dp, NHWC_X.shape[1:], filter_size, stride, dilation)


def _geometry(NHWC_X, filter_size, stride, dilation):
    N, H, W, C = NHWC_X.shape
    Hout = out_size(H, filter_size, stride, dilation)
    Wout = out_size(W, filter_size, stride, dilation)
    return Hout * Wout, filter_size * filter_size * C


def conv_rbf_cross_plain(NHWC_X, Z, variance, gamma, u, wkd, filter_size,
                         stride=1, dilation=1, with_kdiag=True,
                         matmul=torch.matmul):
    """Plain PyTorch version of the forward kernel: im2col, distances, exp
    and the patch sums, materialized.  ``u`` and ``wkd`` are [P] in TF
    patch order; Kdiag is zeros unless ``with_kdiag``.  ``matmul`` forms
    the two products (:func:`conv_rbf_cross_3xtf32` passes the split-TF32
    emulation)."""
    patches = extract_patches(NHWC_X, filter_size, stride, dilation)  # [N,P,L]
    P = patches.shape[1]
    pn = patches.square().sum(-1)                                     # [N, P]
    zn = Z.square().sum(-1)                                           # [M]
    D = pn[:, :, None] + zn - 2.0 * matmul(patches, Z.T)
    K = variance * torch.exp(gamma * D.clamp_min(0.0))
    kzx = torch.einsum('npm,p->nm', K, u)
    if not with_kdiag:
        return kzx, torch.zeros_like(kzx[:, 0])
    G = matmul(patches, patches.transpose(1, 2))
    E = pn[:, :, None] + pn[:, None, :] - 2.0 * G
    Kd = variance * torch.exp(gamma * E.clamp_min(0.0))
    W2 = wkd[:, None] * wkd[None, :] / (P * P)
    return kzx, (Kd * W2).sum((1, 2))


def col2im(dpatches, image_shape, filter_size, stride=1, dilation=1):
    """Adjoint of :func:`extract_patches`: [N, P, L] -> [N, H, W, C], the
    patch elements summed into the pixels they were read from."""
    N = dpatches.shape[0]
    H, W, C = image_shape
    idx = pixel_index(image_shape, filter_size, stride, dilation,
                      device=dpatches.device)                         # [P*L]
    out = dpatches.new_zeros(N, H * W * C)
    out.index_add_(1, idx, dpatches.reshape(N, -1))
    return out.reshape(N, H, W, C)


def conv_rbf_cross_bwd_plain(NHWC_X, Z, variance, gamma, u, wkd, filter_size,
                             stride, dilation, with_kdiag, dkzx, dkd,
                             with_dimg=True):
    """Plain PyTorch version of the backward kernels: the formulas of the
    TPU kernel's ``_bwd_kernel`` on materialized [N, P, M] and [N, P, P]
    tensors, with the same strict masks D > 0 and E > 0 (not the gradient
    of ``clamp_min``, which passes at D == 0).  Returns (d images, dZ,
    d variance, d gamma, du, dwkd); d images is None unless
    ``with_dimg``."""
    patches = extract_patches(NHWC_X, filter_size, stride, dilation)  # [N,P,L]
    P = patches.shape[1]
    pn = patches.square().sum(-1)
    zn = Z.square().sum(-1)
    D = pn[:, :, None] + zn - 2.0 * (patches @ Z.T)                   # [N,P,M]
    Dhat = D.clamp_min(0.0)
    K = variance * torch.exp(gamma * Dhat)
    AUK = u[None, :, None] * dkzx[:, None, :] * K
    dvar = AUK.sum() / variance
    dgamma = (AUK * Dhat).sum()
    T = AUK * gamma * (D > 0).to(K.dtype)
    dpatches = -2.0 * (T @ Z) + 2.0 * patches * T.sum(-1, keepdim=True)
    dZ = (-2.0 * torch.einsum('npm,npl->ml', T, patches)
          + 2.0 * Z * T.sum((0, 1))[:, None])
    du = torch.einsum('nm,npm->p', dkzx, K)
    if with_kdiag:
        G = patches @ patches.transpose(1, 2)
        E = pn[:, :, None] + pn[:, None, :] - 2.0 * G                 # [N,P,P]
        Ehat = E.clamp_min(0.0)
        Kd = variance * torch.exp(gamma * Ehat)
        W2 = wkd[:, None] * wkd[None, :] / (P * P)
        base = dkd[:, None, None] * W2 * Kd
        dvar = dvar + base.sum() / variance
        dgamma = dgamma + (base * Ehat).sum()
        S = base * gamma * (E > 0).to(K.dtype)
        Ssym = S + S.transpose(1, 2)
        dpatches = (dpatches - 2.0 * (Ssym @ patches)
                    + 2.0 * patches * Ssym.sum(-1, keepdim=True))
        KdS = Kd + Kd.transpose(1, 2)
        dwkd = (dkd[:, None] * (KdS * wkd).sum(-1)).sum(0) / (P * P)
    else:
        dwkd = torch.zeros_like(wkd)
    dimg = (col2im(dpatches, NHWC_X.shape[1:], filter_size, stride, dilation)
            if with_dimg else None)
    return dimg, dZ, dvar, dgamma, du, dwkd


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does; the result is float32
    with its 13 low mantissa bits zero.  Subnormals round the same way;
    +-inf and NaN pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor):
    """(hi, lo) as the kernels split x: hi = :func:`tf32_round` (x); lo =
    x - hi, exact in float32, as the tensor cores read it: truncated to
    TF32.  hi + lo carries x to within 2^-21 of |x|."""
    hi = tf32_round(x)
    lo = x - hi
    return hi, (lo.view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32 as the kernels' split-TF32 tensor-core products
    form it: lo*hi + hi*lo, then + hi*hi (each product of two TF32 values
    is exact in float32; lo*lo, below 2^-21 of the terms, is dropped)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def conv_rbf_cross_3xtf32(NHWC_X, Z, variance, gamma, u, wkd, filter_size,
                          stride=1, dilation=1, with_kdiag=True):
    """:func:`conv_rbf_cross_plain` with its two products (patches Z^T and
    the Kdiag gram) in split TF32, as K4 forms them: the emulation the
    tests hold against the float32 and float64 references."""
    return conv_rbf_cross_plain(NHWC_X, Z, variance, gamma, u, wkd,
                                filter_size, stride, dilation, with_kdiag,
                                matmul_3xtf32)


def bwd_dz_3xtf32(NHWC_X, Z, variance, gamma, u, filter_size, stride,
                  dilation, dkzx):
    """dZ of :func:`conv_rbf_cross_bwd_plain` with T^T patches in split
    TF32, as K5's Z side forms it from the float32 T of the image side."""
    patches = extract_patches(NHWC_X, filter_size, stride, dilation)  # [N,P,L]
    N, P, L = patches.shape
    pn = patches.square().sum(-1)
    zn = Z.square().sum(-1)
    D = pn[:, :, None] + zn - 2.0 * (patches @ Z.T)
    K = variance * torch.exp(gamma * D.clamp_min(0.0))
    T = (u[None, :, None] * dkzx[:, None, :] * K) * gamma * (D > 0).to(K.dtype)
    return _dz_3xtf32(T, patches, Z)


def _dz_3xtf32(T, patches, Z):
    """The Z side from T [N, P, >= M]: 2 (Z colsum T - T^T patches), the
    product in split TF32."""
    N, P, L = patches.shape
    T2 = T.reshape(N * P, -1)[:, :Z.shape[0]]
    return (-2.0 * matmul_3xtf32(T2.T, patches.reshape(N * P, L))
            + 2.0 * Z * T2.sum(0)[:, None])


def bwd_tiled_3xtf32(NHWC_X, Z, variance, gamma, u, wkd, filter_size, stride,
                     dilation, with_kdiag, dkzx, dkd, with_dimg=True):
    """The row-tiled image side (``bwd_image_kernel_tiled``) emulated unit
    by unit: each unit's products in split TF32 on its 128-row tiles
    (rows past P zero), its masks and partials into the slots of
    :func:`tiled_plan`, an off-diagonal gram pair counted twice and its
    dpatches parts 2 S patches_b and 2 S^T patches_a, a diagonal one's
    (S + S^T) patches_a; then :func:`sum_tiled_partials`,
    :func:`tiled_dimg` and the Z side on T.  Returns what
    :func:`conv_rbf_cross_bwd_plain` does."""
    patches = extract_patches(NHWC_X, filter_size, stride, dilation)
    N, P, L = patches.shape
    M = Z.shape[0]
    plan = tiled_plan(N, P, M, L, with_kdiag, with_dimg)
    R, T, Lx = plan['row_tiles'], plan['col_tiles'], plan['Lx']
    B = TILED_ROWS
    new = functools.partial(torch.zeros, dtype=Z.dtype)
    Zp = new(T * _MT, Lx)
    Zp[:M, :L] = Z
    dk = new(N, T * _MT)
    dk[:, :M] = dkzx
    Xp = new(N, R * B, Lx)
    Xp[:, :P, :L] = patches
    up, wp = new(R * B), new(R * B)
    up[:P], wp[:P] = u, wkd
    live = torch.arange(R * B) < P
    pn, zn = Xp.square().sum(-1), Zp.square().sum(-1)
    sc, du = new(plan['scalars']), new(plan['du'])
    dw = new(plan['dwkd']) if with_kdiag else None
    rx = new(plan['rx']) if with_dimg else None
    rsum = new(plan['rsum']) if with_dimg else None
    Tg = new(N, P, T * _MT)
    fw = 2.0 * dkd / (P * P)
    for i, (kind, a, b) in enumerate(tiled_units(P, M, with_kdiag)):
        ra, rb = slice(a * B, (a + 1) * B), slice(b * B, (b + 1) * B)
        A = Xp[:, ra]
        if kind == 'cross':
            D = pn[:, ra, None] + zn[rb] - 2.0 * matmul_3xtf32(A, Zp[rb].T)
            Dh = D.clamp_min(0.0)
            ak = dk[:, None, rb] * (variance * torch.exp(gamma * Dh))
            auk = up[ra][None, :, None] * ak
            Tu = torch.where(D > 0, auk * gamma, torch.zeros_like(auk))
            sc[:, i, 0], sc[:, i, 1] = auk.sum((1, 2)), (auk * Dh).sum((1, 2))
            du[:, a, b] = ak.sum(-1) * live[ra]
            Tg[:, a * B:min(P, (a + 1) * B), rb] = Tu[:, :min(B, P - a * B)]
            if with_dimg:
                rx[:, a, b] = matmul_3xtf32(Tu, Zp[rb])
                rsum[:, a, b] = Tu.sum(-1)
            continue
        Xb = Xp[:, rb]
        E = pn[:, ra, None] + pn[:, None, rb] - 2.0 * matmul_3xtf32(
            A, Xb.transpose(1, 2))
        Eh = E.clamp_min(0.0)
        ok = live[ra][:, None] & live[rb][None, :]
        kd = torch.where(ok, variance * torch.exp(gamma * Eh),
                         torch.zeros_like(E))
        base = dkd[:, None, None] * (wp[ra][:, None] * wp[rb]) / (P * P) * kd
        mult = 1.0 if a == b else 2.0
        sc[:, i, 0] = mult * base.sum((1, 2))
        sc[:, i, 1] = mult * (base * Eh).sum((1, 2))
        S = torch.where(E > 0, base * gamma, torch.zeros_like(base))
        dw[:, a, b] = fw[:, None] * (kd * wp[rb]).sum(-1)
        if a != b:
            dw[:, b, a] = fw[:, None] * (kd * wp[ra][:, None]).sum(1)
        if not with_dimg:
            continue
        if a == b:
            Ss = S + S.transpose(1, 2)
            rx[:, a, T + a] = matmul_3xtf32(Ss, A)
            rsum[:, a, T + a] = Ss.sum(-1)
        else:
            rx[:, a, T + b] = 2.0 * matmul_3xtf32(S, Xb)
            rsum[:, a, T + b] = 2.0 * S.sum(-1)
            rx[:, b, T + a] = 2.0 * matmul_3xtf32(S.transpose(1, 2), A)
            rsum[:, b, T + a] = 2.0 * S.sum(1)
    dvar, dgamma, du, dwkd = sum_tiled_partials(sc, du, dw, P, variance)
    dimg = (tiled_dimg(NHWC_X, rx, rsum, filter_size, stride, dilation)
            if with_dimg else None)
    return dimg, _dz_3xtf32(Tg, patches, Z), dvar, dgamma, du, dwkd


# Per kind, (Z, Z._version, padded copy) of the last inducing matrix: a
# served model passes the same Z on every call, and a training step reads
# the same Z in its forward and backward, so each copy is built once and
# rebuilt when Z is another tensor or was written in place.  A CUDA graph
# replay runs no Python: it reads every tensor where its capture found
# it, so a copy built outside a capture would be read stale by every
# later replay (an eval graph captured before a training step, say), and
# it writes Z without bumping Z._version.  So while the current stream is
# capturing, the copy is built inside the captured region on every call
# and kept out of the cache, and every replay empties the cache
# (:func:`drop_padded_copies`, called by ``training.graphs``).  The eager
# run that precedes a capture builds them the same way
# (:func:`built_every_call`), so that it launches what the replays do.
_pad_cache: dict = {}
_EVERY_CALL: list = []


def drop_padded_copies() -> None:
    """Forget every padded copy: Z may have been written behind its
    version counter's back."""
    _pad_cache.clear()


@contextlib.contextmanager
def built_every_call():
    """Inside the block every padded copy is built on each call and none
    is cached, as while a graph is captured."""
    _EVERY_CALL.append(True)
    try:
        yield
    finally:
        _EVERY_CALL.pop()


def _cached(kind, Z, build):
    if _EVERY_CALL or (torch.cuda.is_available()
                       and torch.cuda.is_current_stream_capturing()):
        return build(Z)
    hit = _pad_cache.get(kind)
    if hit is not None and hit[0] is Z and hit[1] == Z._version:
        return hit[2]
    out = build(Z)
    _pad_cache[kind] = (Z, Z._version, out)
    return out


def _padded_zt(Z):
    """Z^T [L, Mpad], zero-padded to whole column tiles, as the kernels
    read it; rebuilt when Z is another tensor or was written in place."""
    def build(Z):
        M, L = Z.shape
        Zt = torch.zeros(L, -(-M // _MT) * _MT, dtype=Z.dtype, device=Z.device)
        Zt[:, :M] = Z.detach().T
        return Zt
    return _cached('zt', Z, build)


def _padded_z(Z):
    """Z [Mpad, Lpad], zero-padded to whole tiles both ways (the forward
    and the backward's image side read its rows as float4s)."""
    def build(Z):
        M, L = Z.shape
        Zp = torch.zeros(-(-M // _MT) * _MT, -(-L // _MT) * _MT,
                         dtype=Z.dtype, device=Z.device)
        Zp[:M, :L] = Z.detach()
        return Zp
    return _cached('zp', Z, build)


def _padded_zn(Z):
    """The squared norms of Z's rows [Mpad], zero-padded: the backward's
    image side reads them instead of summing them in every block."""
    def build(Z):
        zn = torch.zeros(-(-Z.shape[0] // _MT) * _MT, dtype=Z.dtype,
                         device=Z.device)
        zn[:Z.shape[0]] = Z.detach().square().sum(1)
        return zn
    return _cached('zn', Z, build)


def _check_cuda(name, tensors: dict, device):
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f'{name}: {key} on {t.device}')
        if t.dtype != torch.float32:
            raise TypeError(f'{name}: float32 only, {key} is {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {key} must be contiguous')


def _launch(NHWC_X, Z, scal, u, wkd, filter_size, stride, dilation,
            with_kdiag):
    N, H, W, C = NHWC_X.shape
    M = Z.shape[0]
    Zp = _padded_z(Z)
    Mpad, Lpad = Zp.shape
    P = u.shape[0]
    kzx = torch.empty(N, M, dtype=Z.dtype, device=Z.device)
    kd = torch.empty(N, dtype=Z.dtype, device=Z.device)
    pairs = fwd_gram_pairs(P) if with_kdiag else 0
    kdpart = (torch.empty(N, pairs, dtype=Z.dtype, device=Z.device)
              if pairs > 1 else None)
    fn = cuda_build.function(
        'conv_rbf_cross', 'conv_rbf_cross',
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(Z.device).cuda_stream
    with profiling.launch('conv_rbf_cross', (NHWC_X, Zp, scal, u, wkd),
                          (kzx, kd if kdpart is None else kdpart)):
        cuda_build.check(fn(NHWC_X.data_ptr(), Zp.data_ptr(),
                            scal.data_ptr(), u.data_ptr(), wkd.data_ptr(),
                            kzx.data_ptr(), kd.data_ptr(),
                            None if kdpart is None else kdpart.data_ptr(),
                            N, H, W, C, filter_size, stride, dilation, M,
                            Mpad, Lpad, fwd_group(P), int(with_kdiag),
                            stream),
                         'conv_rbf_cross')
    conv_rbf_cross.launches += 1
    if kdpart is not None:
        kd = kdpart.sum(1)
    return kzx, kd


def conv_rbf_cross(NHWC_X, Z, variance, gamma, u, wkd, filter_size,
                   stride=1, dilation=1, with_kdiag=True):
    """(Kzx [N, M], Kdiag [N]) of images NHWC_X [N, H, W, C] against
    inducing patches Z [M, f*f*C] (TF element order).  ``variance`` and
    ``gamma`` = -0.5 / lengthscale^2 are scalar tensors; ``u`` = w / P and
    ``wkd`` = w are [P] in TF patch order.

    CUDA tensors launch the kernel (float32, contiguous, geometry within
    :func:`envelope_bytes`) or raise; CPU tensors take
    :func:`conv_rbf_cross_plain`."""
    if NHWC_X.device.type == 'cpu':
        return conv_rbf_cross_plain(NHWC_X, Z, variance, gamma, u, wkd,
                                    filter_size, stride, dilation, with_kdiag)
    if NHWC_X.device.type != 'cuda':
        raise ValueError(f'conv_rbf_cross: unsupported device {NHWC_X.device}')
    P, L = _geometry(NHWC_X, filter_size, stride, dilation)
    _check_cuda('conv_rbf_cross', dict(NHWC_X=NHWC_X, Z=Z, u=u, wkd=wkd),
                NHWC_X.device)
    if Z.ndim != 2 or Z.shape[1] != L or u.shape != (P,) or wkd.shape != (P,):
        raise ValueError(
            f'conv_rbf_cross: Z {tuple(Z.shape)}, u {tuple(u.shape)}, wkd '
            f'{tuple(wkd.shape)} do not fit P={P}, L={L}')
    if P < 1 or envelope_bytes(P, L) > SMEM_LIMIT:
        raise ValueError(f'conv_rbf_cross: P={P}, L={L} is outside the '
                         'fused route\'s envelope')
    scal = torch.stack([variance, gamma]).to(Z.device, torch.float32)
    return _launch(NHWC_X, Z, scal, u, wkd, filter_size, stride, dilation,
                   with_kdiag)


conv_rbf_cross.launches = 0


def bwd_route(P: int, L: int):
    """The backward's image side for a geometry: 'cluster' (P <= 64, L <=
    512 and the cluster's block within shared memory), 'tiled' (P > 64, L
    <= 512: the row-tiled units, whose shared memory is TILED_SMEM at every
    geometry), or None (the geometry trains unfused)."""
    if 0 < P <= BWD_MAX_P:
        fits = L <= BWD_MAX_L and bwd_smem_bytes(P, L) <= SMEM_LIMIT
        return 'cluster' if fits else None
    if P > BWD_MAX_P and 0 < L <= BWD_MAX_L and TILED_SMEM <= SMEM_LIMIT:
        return 'tiled'
    return None


def bwd_fits(P: int, L: int) -> bool:
    """Whether the backward kernels take a geometry (:func:`bwd_route`)."""
    return bwd_route(P, L) is not None


def _launch_bwd(NHWC_X, Z, scal, u, wkd, filter_size, stride, dilation,
                with_kdiag, dkzx, dkd):
    N, H, W, C = NHWC_X.shape
    M, L = Z.shape
    P = u.shape[0]
    Zt, Zp, zn = _padded_zt(Z), _padded_z(Z), _padded_zn(Z)
    Mpad = Zt.shape[1]
    dev = Z.device
    T = torch.empty(N, P, Mpad, dtype=Z.dtype, device=dev)
    part = torch.empty(N, bwd_cluster(M), 2 * P + 2, dtype=Z.dtype,
                       device=dev)
    dimg = torch.empty_like(NHWC_X)
    stream = torch.cuda.current_stream(dev).cuda_stream
    image = cuda_build.function(
        'conv_rbf_cross_bwd', 'conv_rbf_cross_bwd_image',
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    with profiling.launch('conv_rbf_cross_bwd_image',
                          (NHWC_X, Zt, Zp, zn, scal, u, wkd, dkzx, dkd),
                          (T, part, dimg)):
        cuda_build.check(image(NHWC_X.data_ptr(), Zt.data_ptr(),
                               Zp.data_ptr(), zn.data_ptr(), scal.data_ptr(),
                               u.data_ptr(), wkd.data_ptr(), dkzx.data_ptr(),
                               dkd.data_ptr(), T.data_ptr(), part.data_ptr(),
                               dimg.data_ptr(), N, H, W, C, filter_size,
                               stride, dilation, M, Mpad, int(with_kdiag),
                               stream),
                         'conv_rbf_cross_bwd_image')
    conv_rbf_cross_bwd.launches += 1
    return T, dimg, part


def _launch_tiled(NHWC_X, Z, scal, u, wkd, filter_size, stride, dilation,
                  with_kdiag, dkzx, dkd, with_dimg):
    """The row-tiled image side (and, with d images, its col2im): T, d
    images or None, and the partials (sc, du, dwkd) of
    :func:`sum_tiled_partials`."""
    N, H, W, C = NHWC_X.shape
    M, L = Z.shape
    P = u.shape[0]
    Zp = _padded_z(Z)
    Mpad, Lpad = Zp.shape
    plan = tiled_plan(N, P, M, L, with_kdiag, with_dimg)
    dev = Z.device

    def new(shape):
        return None if shape is None else torch.empty(shape, dtype=Z.dtype,
                                                      device=dev)
    T = new((N, P, Mpad))
    sc, dup, dwp = new(plan['scalars']), new(plan['du']), new(plan['dwkd'])
    rx, rsum = new(plan['rx']), new(plan['rsum'])
    stream = torch.cuda.current_stream(dev).cuda_stream
    image = cuda_build.function(
        'conv_rbf_cross_bwd', 'conv_rbf_cross_bwd_image_tiled',
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 13 + [ctypes.c_void_p])

    def ptr(t):
        return None if t is None else t.data_ptr()
    with profiling.launch('conv_rbf_cross_bwd_image',
                          (NHWC_X, Zp, scal, u, wkd, dkzx, dkd),
                          (T, sc, dup, dwp, rx, rsum)):
        cuda_build.check(image(
            NHWC_X.data_ptr(), Zp.data_ptr(), scal.data_ptr(), u.data_ptr(),
            wkd.data_ptr(), dkzx.data_ptr(), dkd.data_ptr(), T.data_ptr(),
            sc.data_ptr(), dup.data_ptr(), ptr(dwp), ptr(rx), ptr(rsum), N, H,
            W, C, filter_size, stride, dilation, M, Mpad, Lpad, plan['Lx'],
            int(with_kdiag), int(with_dimg), stream),
            'conv_rbf_cross_bwd_image_tiled')
    conv_rbf_cross_bwd.launches += 1
    conv_rbf_cross_bwd.tiled_launches += 1
    dimg = None
    if with_dimg:
        dimg = torch.empty_like(NHWC_X)
        col2im_fn = cuda_build.function(
            'conv_rbf_cross_bwd', 'conv_rbf_cross_bwd_image_tiled_col2im',
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        with profiling.launch('conv_rbf_cross_bwd_image', (NHWC_X, rx, rsum),
                              (dimg,)):
            cuda_build.check(col2im_fn(
                NHWC_X.data_ptr(), rx.data_ptr(), rsum.data_ptr(),
                dimg.data_ptr(), N, H, W, C, filter_size, stride, dilation,
                Mpad, int(with_kdiag), plan['Lx'], stream),
                'conv_rbf_cross_bwd_image_tiled_col2im')
        conv_rbf_cross_bwd.launches += 1
    return T, dimg, (sc, dup, dwp)


def _launch_z(NHWC_X, Z, T, filter_size, stride, dilation):
    """The Z side: dZ from T [N, P, Mpad]."""
    N, H, W, C = NHWC_X.shape
    M, L = Z.shape
    P = T.shape[1]
    Mpad = T.shape[2]
    dev = Z.device
    dZ = torch.empty_like(Z)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cluster = z_side_cluster(
        N, P, M, L, torch.cuda.get_device_properties(dev).multi_processor_count)
    zside = cuda_build.function(
        'conv_rbf_cross_bwd', 'conv_rbf_cross_bwd_z',
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    with profiling.launch('conv_rbf_cross_bwd_z', (NHWC_X, Z, T), (dZ,)):
        cuda_build.check(zside(NHWC_X.data_ptr(), Z.data_ptr(), T.data_ptr(),
                               dZ.data_ptr(), N, H, W, C, filter_size, stride,
                               dilation, M, Mpad, cluster, stream),
                         'conv_rbf_cross_bwd_z')
    conv_rbf_cross_bwd.launches += 1
    return dZ


def conv_rbf_cross_bwd(NHWC_X, Z, variance, gamma, u, wkd, filter_size,
                       stride, dilation, with_kdiag, dkzx, dkd,
                       with_dimg=True):
    """Gradients of :func:`conv_rbf_cross` for the cotangents dkzx [N, M]
    and dkd [N] (read only with Kdiag): (d images, dZ, d variance,
    d gamma, du, dwkd).  Without ``with_dimg`` the row-tiled image side
    (P > 64) skips d images and returns None for them; the cluster one
    (P <= 64) always computes them.

    CUDA tensors launch the backward kernels (float32, contiguous,
    :func:`bwd_route` geometry: the image side -- for P > 64 with d images
    also its col2im -- then the Z side) or raise; CPU tensors take
    :func:`conv_rbf_cross_bwd_plain`."""
    if NHWC_X.device.type == 'cpu':
        return conv_rbf_cross_bwd_plain(NHWC_X, Z, variance, gamma, u, wkd,
                                        filter_size, stride, dilation,
                                        with_kdiag, dkzx, dkd, with_dimg)
    if NHWC_X.device.type != 'cuda':
        raise ValueError(f'conv_rbf_cross_bwd: unsupported device {NHWC_X.device}')
    P, L = _geometry(NHWC_X, filter_size, stride, dilation)
    N, M = NHWC_X.shape[0], Z.shape[0]
    _check_cuda('conv_rbf_cross_bwd',
                dict(NHWC_X=NHWC_X, Z=Z, u=u, wkd=wkd, dkzx=dkzx, dkd=dkd),
                NHWC_X.device)
    if (Z.shape[1] != L or u.shape != (P,) or wkd.shape != (P,)
            or dkzx.shape != (N, M) or dkd.shape != (N,)):
        raise ValueError('conv_rbf_cross_bwd: shapes do not fit the geometry')
    route = bwd_route(P, L)
    if route is None:
        raise NotImplementedError(
            f'conv_rbf_cross_bwd: P={P}, L={L} is outside the backward '
            f'kernels (L <= {BWD_MAX_L}, and for P <= {BWD_MAX_P} the '
            'cluster\'s shared memory); models route such a geometry '
            'unfused (see fused_fits)')
    scal = torch.stack([variance, gamma]).to(Z.device, torch.float32)
    if route == 'cluster':
        T, dimg, part = _launch_bwd(NHWC_X, Z, scal, u, wkd, filter_size,
                                    stride, dilation, with_kdiag, dkzx, dkd)
        dZ = _launch_z(NHWC_X, Z, T, filter_size, stride, dilation)
        return (dimg, dZ) + sum_bwd_partials(part, P)
    T, dimg, parts = _launch_tiled(NHWC_X, Z, scal, u, wkd, filter_size,
                                   stride, dilation, with_kdiag, dkzx, dkd,
                                   with_dimg)
    dZ = _launch_z(NHWC_X, Z, T, filter_size, stride, dilation)
    return (dimg, dZ) + sum_tiled_partials(*parts, P, scal[0])


# Launches of every backward kernel, and of the row-tiled image side alone.
conv_rbf_cross_bwd.launches = 0
conv_rbf_cross_bwd.tiled_launches = 0


class _FusedConvRBFCross(torch.autograd.Function):
    """K4 forward, K5 backward.  Saves only the inputs, as the JAX custom
    VJP's ``_vjp_fwd`` does; the backward recomputes the rest, and asks
    for d images only when the images need a gradient."""

    @staticmethod
    def forward(ctx, NHWC_X, Z, variance, gamma, u, wkd, filter_size, stride,
                dilation, with_kdiag):
        ctx.save_for_backward(NHWC_X, Z, variance, gamma, u, wkd)
        ctx.geometry = (filter_size, stride, dilation, with_kdiag)
        return conv_rbf_cross(NHWC_X, Z, variance, gamma, u, wkd,
                              filter_size, stride, dilation, with_kdiag)

    @staticmethod
    def backward(ctx, dkzx, dkd):
        NHWC_X, Z, variance, gamma, u, wkd = ctx.saved_tensors
        filter_size, stride, dilation, with_kdiag = ctx.geometry
        N, M = NHWC_X.shape[0], Z.shape[0]
        dkzx = (Z.new_zeros(N, M) if dkzx is None
                else dkzx.to(Z.dtype).contiguous())
        dkd = (Z.new_zeros(N) if dkd is None or not with_kdiag
               else dkd.to(Z.dtype).contiguous())
        dimg, dZ, dvar, dgamma, du, dwkd = conv_rbf_cross_bwd(
            NHWC_X, Z, variance, gamma, u, wkd, filter_size, stride,
            dilation, with_kdiag, dkzx, dkd, ctx.needs_input_grad[0])
        return (dimg, dZ, dvar.reshape(variance.shape).to(variance.dtype),
                dgamma.reshape(gamma.shape).to(gamma.dtype), du, dwkd,
                None, None, None, None)


def fused_conv_rbf_cross(NHWC_X, Z, variance, gamma, u, wkd, filter_size,
                         stride=1, dilation=1, with_kdiag=True):
    """Differentiable :func:`conv_rbf_cross`: K4 forward, K5 backward (the
    plain versions of both on CPU tensors)."""
    return _FusedConvRBFCross.apply(NHWC_X, Z, variance, gamma, u, wkd,
                                    filter_size, stride, dilation, with_kdiag)


def supported(kernel) -> bool:
    """Whether ``kernel`` (a patch-sum kernel) evaluates through the fused
    path: scalar-lengthscale RBF base over a FullView whose geometry lies
    within :func:`envelope_bytes`.  Mirrors ``pallas_cross.kernel_supported``;
    the CUDA kernel takes any batch size, so there is no block rule.  The
    backward's narrower envelope is :func:`bwd_fits`."""
    from deepcgp_tpu_torch.models.base_kernels import RBF
    from deepcgp_tpu_torch.models.conv_kernels import AdditivePatchKernel
    from deepcgp_tpu_torch.models.views import FullView
    if not isinstance(kernel, AdditivePatchKernel):
        return False
    view = kernel.view
    base = kernel.base_kernel
    return (isinstance(view, FullView) and isinstance(base, RBF)
            and base.raw_lengthscales.ndim == 0
            and envelope_bytes(view.patch_count, view.patch_length)
            <= SMEM_LIMIT)


def fused_fits(kernel) -> bool:
    """Whether ``kernel.Kzx_NM_and_Kdiag`` takes the fused route (K4
    forward, K5 backward): :func:`supported` and the backward's
    :func:`bwd_fits` (P <= 64 on the cluster image side, P > 64 on the
    row-tiled one, L <= 512 on both).  Geometry alone decides, the same on the CPU and the
    card and with or without autograd, so a model serves through the route
    it trains on (the counterpart of ``pallas_cross.supported_for``).
    Everything else goes unfused: extraction (K6), plain products, and
    col2im (K7) in the backward."""
    return (supported(kernel)
            and bwd_fits(kernel.view.patch_count, kernel.view.patch_length))


def kzx_and_kdiag(kernel, Z, ND_X):
    """The fused evaluation of ``kernel.Kzx_NM_and_Kdiag(Z, ND_X)``,
    differentiable in every input.

    ConvKernel: Kdiag is the weighted double patch sum from the kernel's
    in-block gram.  AdditivePatchKernel: the RBF Kdiag is the constant
    variance * mean(w), computed outside, and the kernel skips its gram."""
    from deepcgp_tpu_torch.models.conv_kernels import ConvKernel
    if not supported(kernel):
        raise NotImplementedError(
            'the fused cross-covariance takes a scalar-lengthscale RBF over a '
            'FullView within its envelope; evaluate other kernels through '
            'kernel.Kzx_NM_and_Kdiag, which routes them unfused')
    view = kernel.view
    base = kernel.base_kernel
    N = ND_X.shape[0]
    H, W = view.input_size
    NHWC = ND_X.reshape(N, H, W, view.feature_maps).contiguous()
    w = kernel.patch_weights
    with_kdiag = isinstance(kernel, ConvKernel)
    gamma = -0.5 / base.lengthscales.square()
    kzx, kdiag = fused_conv_rbf_cross(NHWC, Z, base.variance, gamma,
                                      w / view.patch_count, w,
                                      view.filter_size, view.stride,
                                      view.dilation, with_kdiag)
    if not with_kdiag:
        kdiag = kernel.Kdiag(ND_X)
    return kzx, kdiag
