"""Host-side pieces of the backward kernel K5 (``ops/cuda_cross.py``) on
the CPU: the image side's per-(image, cluster rank) partial layout that
the wrapper sums, the cluster size, and the fused-route gate, which must
send the geometries the tests and paths use where it always has.  The
kernel itself runs only on the card (``chip_smoke.py``); its arithmetic
is held there against ``conv_rbf_cross_bwd_plain``."""

import numpy as np
import pytest
import torch

from deepcgp_tpu_torch.ops import cuda_cross
from deepcgp_tpu_torch.ops.patches import extract_patches


def _partials_by_rank(X, Z, var, gamma, u, wkd, f, s, d, with_kdiag, dkzx,
                      dkd, S):
    """The image side's partials [N, S, 2P + 2] as its blocks deal out the
    work: rank r takes the 128-column tiles r, r + S, ... of M for du,
    dvar and dgamma's cross-covariance terms, and the gram pairs p <= q
    whose index t in the upper triangle has t mod S == r, both entries of
    each, for dwkd and the gram terms.  Plain float64
    formulas of the kernel's, one rank at a time."""
    patches = extract_patches(X, f, s, d)                          # [N,P,L]
    N, P, _ = patches.shape
    M = Z.shape[0]
    pn = patches.square().sum(-1)
    D = pn[:, :, None] + Z.square().sum(-1) - 2.0 * patches @ Z.T
    K = var * torch.exp(gamma * D.clamp_min(0.0))
    AUK = u[None, :, None] * dkzx[:, None, :] * K
    E = pn[:, :, None] + pn[:, None, :] - 2.0 * patches @ patches.transpose(1, 2)
    Kd = var * torch.exp(gamma * E.clamp_min(0.0))
    base = dkd[:, None, None] * wkd[:, None] * wkd[None, :] / P ** 2 * Kd
    part = torch.zeros(N, S, 2 * P + 2, dtype=X.dtype)
    tiles = -(-M // 128)
    # Pairs p <= q numbered row by row through the upper triangle; a rank
    # takes both entries of each pair it owns.
    lo = torch.minimum(torch.arange(P)[:, None], torch.arange(P)[None, :])
    hi = torch.maximum(torch.arange(P)[:, None], torch.arange(P)[None, :])
    pair_rank = (lo * P - lo * (lo - 1) // 2 + hi - lo) % S
    for r in range(S):
        cols = torch.zeros(M, dtype=torch.bool)
        for t in range(r, tiles, S):
            cols[128 * t:128 * (t + 1)] = True
        part[:, r, :P] = torch.einsum('nm,npm->np', dkzx[:, cols], K[:, :, cols])
        dvar = AUK[:, :, cols].sum((1, 2)) / var
        dgam = (AUK[:, :, cols] * D[:, :, cols].clamp_min(0.0)).sum((1, 2))
        if with_kdiag:
            own = (pair_rank == r).to(X.dtype)
            part[:, r, P:2 * P] = (2.0 * dkd[:, None] / P ** 2
                                   * ((Kd * own) * wkd).sum(-1))
            dvar = dvar + (base * own).sum((1, 2)) / var
            dgam = dgam + (base * own * E.clamp_min(0.0)).sum((1, 2))
        part[:, r, 2 * P] = dvar
        part[:, r, 2 * P + 1] = dgam
    return part


@pytest.mark.parametrize('H,W,C,f,s,M,with_kdiag', [
    (10, 10, 10, 5, 1, 384, True),     # the flagship's last layer: S = 3
    (15, 13, 10, 3, 2, 200, True),     # chip_smoke.py's odd geometry: S = 2
    (15, 13, 10, 3, 2, 200, False),
    (6, 6, 2, 3, 1, 1100, True),       # 9 tiles on a cluster of 8
])
def test_bwd_partials_by_rank_sum_to_the_plain_backward(H, W, C, f, s, M,
                                                        with_kdiag):
    """The wrapper's sum of the per-(image, rank) partials equals the
    plain backward's du, dwkd, dvar and dgamma (float64, 1e-12): however
    the cluster deals out tiles and gram pairs, each term is counted once."""
    rng = np.random.RandomState(M)
    N = 3
    X = torch.tensor(rng.randn(N, H, W, C))
    L = f * f * C
    Z = torch.tensor(rng.randn(M, L)) * 0.5
    P = extract_patches(X, f, s, 1).shape[1]
    var, gamma = torch.tensor(1.3), torch.tensor(-0.5 / L)
    u, wkd = torch.tensor(rng.rand(P) + 0.5), torch.tensor(rng.rand(P) + 0.5)
    dkzx, dkd = torch.tensor(rng.randn(N, M)), torch.tensor(rng.randn(N))
    S = cuda_cross.bwd_cluster(M)
    assert S == min(-(-M // 128), 8)
    part = _partials_by_rank(X, Z, var, gamma, u, wkd, f, s, 1, with_kdiag,
                             dkzx, dkd, S)
    dvar, dgamma, du, dwkd = cuda_cross.sum_bwd_partials(part, P)
    ref = cuda_cross.conv_rbf_cross_bwd_plain(X, Z, var, gamma, u, wkd, f, s,
                                              1, with_kdiag, dkzx, dkd)
    for got, want in ((dvar, ref[2]), (dgamma, ref[3]), (du, ref[4]),
                      (dwkd, ref[5])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))


def test_bwd_cluster_sizes():
    """One block per 128-column tile of M, capped at a portable cluster."""
    assert [cuda_cross.bwd_cluster(M) for M in (1, 128, 129, 200, 384, 1024,
                                                1025, 4096)] == \
        [1, 1, 2, 2, 3, 8, 8, 8]


def _old_bwd_smem_bytes(P, L):
    """The image side's shared memory before the cluster design (the
    patches in two layouts, a tile of T, S and small buffers)."""
    Ppad = -(-P // 8) * 8
    Lpad = -(-L // 128) * 128
    return 4 * (L * Ppad + Ppad * Lpad + 128 * Ppad + Ppad * (Ppad + 1)
                + 3 * Ppad + 128 + 16)


@pytest.mark.parametrize('P,L,fits', [
    (36, 250, True),      # flagship last layer, fused
    (36, 800, False),     # CIFAR fm32 (L = 800), unfused
    (576, 25, False),     # MNIST single-layer ConvKernel (P = 576), unfused
    (42, 90, True),       # chip_smoke.py's stride-2 geometry
    (36, 9, True), (20, 27, True), (64, 18, True),   # the parity tests'
    (100, 250, False),    # 14 x 14 input: P = 100
    (64, 512, False), (64, 256, True), (8, 512, True), (36, 513, False)])
def test_bwd_fits_answers_as_before(P, L, fits):
    """The redesign changed the image side's shared memory, but the gate
    answers as before on the geometries the tests and paths use."""
    old = (0 < P <= 64 and L <= 512
           and _old_bwd_smem_bytes(P, L) <= cuda_cross.SMEM_LIMIT)
    assert cuda_cross.bwd_fits(P, L) == old == fits


def test_bwd_fits_keeps_every_fused_geometry():
    """Every geometry the old image side took, the new one takes too: no
    model that trained fused before falls back to the unfused route."""
    for P in range(1, 65):
        for L in range(1, 513):
            if _old_bwd_smem_bytes(P, L) <= cuda_cross.SMEM_LIMIT:
                assert cuda_cross.bwd_fits(P, L), (P, L)


def test_padded_row_norms_of_z():
    """The image side reads Z's squared row norms [Mpad] from the wrapper,
    zero-padded to whole column tiles, built once per inducing matrix and
    anew when it is written in place."""
    Z = torch.tensor(np.random.RandomState(2).randn(200, 27))
    zn = cuda_cross._padded_zn(Z)
    assert zn.shape == (256,)
    np.testing.assert_allclose(zn[:200].numpy(), (Z ** 2).sum(1).numpy(),
                               rtol=1e-14)
    assert (zn[200:] == 0).all()
    assert cuda_cross._padded_zn(Z) is zn
    Z.mul_(2.0)
    zn2 = cuda_cross._padded_zn(Z)
    assert zn2 is not zn
    np.testing.assert_allclose(zn2[:200].numpy(), (Z ** 2).sum(1).numpy(),
                               rtol=1e-14)
