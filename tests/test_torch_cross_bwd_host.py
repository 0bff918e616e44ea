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
    (576, 25, True),      # MNIST single-layer ConvKernel (P = 576): tiled
    (42, 90, True),       # chip_smoke.py's stride-2 geometry
    (36, 9, True), (20, 27, True), (64, 18, True),   # the parity tests'
    (100, 250, True),     # 14 x 14 input: P = 100, tiled
    (64, 512, False), (64, 256, True), (8, 512, True), (36, 513, False)])
def test_bwd_fits_answers_as_before(P, L, fits):
    """The redesign changed the cluster image side's shared memory, but
    for P <= 64 the gate answers as before on the geometries the tests and
    paths use; P > 64 within L <= 512 now takes the row-tiled image
    side."""
    old = (0 < P <= 64 and L <= 512
           and _old_bwd_smem_bytes(P, L) <= cuda_cross.SMEM_LIMIT)
    assert cuda_cross.bwd_fits(P, L) == fits
    if P <= 64:
        assert fits == old
        assert cuda_cross.bwd_route(P, L) == ('cluster' if fits else None)
    else:
        assert cuda_cross.bwd_route(P, L) == 'tiled'


def test_bwd_fits_keeps_every_fused_geometry():
    """Every geometry the old image side took, the new one takes too, and
    on the cluster kernel it always had: no model that trained fused
    before falls back to the unfused route or moves to the row tiles."""
    for P in range(1, 65):
        for L in range(1, 513):
            if _old_bwd_smem_bytes(P, L) <= cuda_cross.SMEM_LIMIT:
                assert cuda_cross.bwd_route(P, L) == 'cluster', (P, L)


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


# ------------------------------------------ the gram's row sums (ROADMAP C7)
# The partial view's last layer (P = 64, L = 25, M = 384: a cluster of 3),
# on images whose patches sit close, so that every off-diagonal Kd counts.
PV = dict(H=12, W=12, C=1, f=5, s=1, M=384)


def _gram(X, f, s, gamma):
    """Kd [N, P, P] of the images' patches, variance 1, float64."""
    patches = extract_patches(X, f, s, 1).to(torch.float64)
    pn = patches.square().sum(-1)
    E = pn[:, :, None] + pn[:, None, :] - 2.0 * patches @ patches.transpose(1, 2)
    return torch.exp(gamma * E.clamp_min(0.0))


def _pair_rank(P, S):
    lo = np.minimum(np.arange(P)[:, None], np.arange(P)[None, :])
    hi = np.maximum(np.arange(P)[:, None], np.arange(P)[None, :])
    return (lo * P - lo * (lo - 1) // 2 + hi - lo) % S


def _row_sums_by_warp(Kd, wkd, own, dtype):
    """dws[p] as the image side forms it on one rank: a warp takes row p,
    lane j the columns q = j, j + 32, ... in order, each adding its owned
    entries' w_q Kd[p, q] in ``dtype``; then the xor butterfly over 16, 8,
    4, 2, 1, lane 0's sum.  The order is a function of P alone."""
    terms = (own[None] * wkd[None, None, :] * Kd).astype(dtype)
    lanes = np.zeros(terms.shape[:2] + (32,), dtype)
    for q in range(terms.shape[2]):
        lanes[:, :, q % 32] = lanes[:, :, q % 32] + terms[:, :, q]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, :, np.arange(32) ^ o]
    return lanes[:, :, 0]


def _row_sums_by_atomics(Kd, wkd, own, order, dtype):
    """dws[p] as shared-memory atomics form it: each owned pair (a <= b)
    adds w_b Kd[a, b] to row a and w_a Kd[a, b] to row b, the pairs in
    ``order`` (all of them in row order when None) -- the order in which
    the threads happen to arrive."""
    N, P, _ = Kd.shape
    pairs = [(a, b) for a in range(P) for b in range(a, P) if own[a, b]]
    out = np.zeros((N, P), dtype)
    for i in range(len(pairs)) if order is None else order:
        a, b = pairs[i]
        out[:, a] = out[:, a] + (wkd[b] * Kd[:, a, b]).astype(dtype)
        if a != b:
            out[:, b] = out[:, b] + (wkd[a] * Kd[:, a, b]).astype(dtype)
    return out, len(pairs)


def test_gram_row_sums_in_a_fixed_order_match_the_pairs_and_jax():
    """The patch-weight gradient's gram term, dwkd_p = sum_n 2 dKdiag /P^2
    sum_q w_q Kd[p, q], formed as the image side now forms it (each rank's
    rows by a warp in a fixed order, ROADMAP C7) equals the pairwise form
    the atomics summed, the plain backward and the JAX package's
    ``_bwd_call`` (interpret mode) in float64 at 1e-12."""
    from deepcgp_tpu.models.views import FullView as JFullView
    from deepcgp_tpu.ops import pallas_cross as jpc
    import jax.numpy as jnp
    H, W, C, f, s, M = (PV[k] for k in ('H', 'W', 'C', 'f', 's', 'M'))
    rng = np.random.RandomState(7)
    N, L = 4, f * f * C
    X = torch.tensor(0.3 * rng.randn(N, H, W, C))
    Z = torch.tensor(rng.randn(M, L)) * 0.3
    Hout, Wout = (H - f) // s + 1, (W - f) // s + 1
    P = Hout * Wout
    var = torch.tensor(1.0, dtype=torch.float64)
    gamma = torch.tensor(-0.5 / L, dtype=torch.float64)
    u, wkd = torch.tensor(rng.rand(P) + 0.5) / P, torch.tensor(rng.rand(P) + 0.5)
    dkzx, dkd = torch.zeros(N, M, dtype=torch.float64), torch.tensor(rng.randn(N))
    S = cuda_cross.bwd_cluster(M)
    assert (P, L, S) == (64, 25, 3)
    Kd = _gram(X, f, s, gamma).numpy()
    ranks = _pair_rank(P, S)
    w = wkd.numpy()
    dws = np.zeros((N, P))
    for r in range(S):
        own = (ranks == r).astype(np.float64)
        by_warp = _row_sums_by_warp(Kd, w, own, np.float64)
        by_pairs, _ = _row_sums_by_atomics(Kd, w, own, None, np.float64)
        np.testing.assert_allclose(by_warp, (own[None] * w * Kd).sum(-1),
                                   rtol=1e-12)
        np.testing.assert_allclose(by_warp, by_pairs, rtol=1e-12)
        dws += by_warp
    dwkd = (2.0 * dkd.numpy()[:, None] / P ** 2 * dws).sum(0)
    plain = cuda_cross.conv_rbf_cross_bwd_plain(X, Z, var, gamma, u, wkd, f,
                                                s, 1, True, dkzx, dkd)[5]
    np.testing.assert_allclose(dwkd, plain.numpy(), rtol=1e-12)
    # The JAX kernel takes its patch weights in transposed order.
    perm = np.array([(p % Wout) * Hout + p // Wout for p in range(P)])
    ut, wt = np.zeros(P), np.zeros(P)
    ut[perm], wt[perm] = u.numpy(), w
    view = JFullView(input_size=(H, W), filter_size=f, feature_maps=C,
                     stride=s)
    jdwkd = np.asarray(jpc._bwd_call(
        jnp.asarray(X.numpy()), jnp.asarray(Z.numpy()), 1.0, float(gamma),
        jnp.asarray(ut), jnp.asarray(wt), view, True, True,
        jnp.asarray(dkzx.numpy()), jnp.asarray(dkd.numpy()))[5])
    np.testing.assert_allclose(dwkd, jdwkd[perm], rtol=1e-12)


def test_gram_row_sums_no_longer_depend_on_arrival_order():
    """In float32 the atomics' row sums change with the order the threads
    arrive in -- the run-to-run difference of ROADMAP C7 -- while the
    warp's fixed order gives one answer, within float32's rounding of the
    float64 sum."""
    H, W, C, f, s, M = (PV[k] for k in ('H', 'W', 'C', 'f', 's', 'M'))
    rng = np.random.RandomState(8)
    N, L = 2, f * f * C
    X = torch.tensor(0.3 * rng.randn(N, H, W, C))
    Kd64 = _gram(X, f, s, -0.5 / L).numpy()
    Kd = Kd64.astype(np.float32)
    P = Kd.shape[1]
    w = (rng.rand(P) + 0.5).astype(np.float32)
    own = (_pair_rank(P, 3) == 0).astype(np.float32)
    npairs = int(np.triu(own).sum())
    seen = {_row_sums_by_atomics(Kd, w, own, rng.permutation(npairs),
                                 np.float32)[0].tobytes() for _ in range(6)}
    assert len(seen) > 1
    by_warp = _row_sums_by_warp(Kd, w, own, np.float32)
    assert by_warp.tobytes() == _row_sums_by_warp(Kd, w, own,
                                                  np.float32).tobytes()
    np.testing.assert_allclose(by_warp, (own[None] * w * Kd64).sum(-1),
                               rtol=1e-6)
