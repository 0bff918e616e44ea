"""K2, the whole upper Cholesky factor of the NatGrad G in one cluster
launch, on the CPU: its plain version (``cuda_linalg.chol_upper_blocked``
on a CPU tensor: K1's block order on J G J read from G's lower triangle)
against the JAX upper driver with its Pallas base case in interpret mode,
its diagonal-block inverses, its reading of the lower triangle only, its
NaN isolation; the kernel's split of a matrix over its cluster
(``cuda_linalg.upper_plan``) for every M it takes; the kernel's tile
schedule and data flow (two panel buffers a block, panel rows read from
their owners), emulated tile by tile in numpy; and the NatGrad solve at
M = 1088 on the K2 route against the float64 library.  Inputs are numpy
arrays from a seeded RandomState handed to both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.ops import pallas_linalg

from deepcgp_tpu_torch.ops import cuda_linalg
from deepcgp_tpu_torch.training import optim

W = cuda_linalg.W


@pytest.fixture(scope='module', autouse=True)
def _compiled_pallas():
    """The Pallas upper base case through one ``jax.jit`` in interpret
    mode, so that a shape is traced once; the driver stays the JAX
    package's own."""
    mp = pytest.MonkeyPatch()
    fn = jax.jit(functools.partial(pallas_linalg.chol_inv_base_upper,
                                   interpret=True))
    mp.setattr(pallas_linalg, 'chol_inv_base_upper',
               lambda D, interpret=None: fn(D))
    yield
    mp.undo()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _spd(rng, B, M, jitter=2.0):
    A = rng.randn(B, M, M)
    return A @ np.swapaxes(A, -1, -2) / M + jitter * np.eye(M)


def _close(a, b, tol):
    """max |a - b| within ``tol`` of max |b|."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def _dirty(rng, S):
    """S's lower triangle with garbage strictly above the diagonal, inside
    the 8x8 diagonal sub-blocks too."""
    return np.tril(S) + np.triu(rng.randn(*S.shape) * 1e6, 1)


@pytest.mark.parametrize('M', [64, 128, 192])
def test_k2_plain_matches_jax_upper_driver(M):
    """R = J Lf J and R^-1 = J (K3's plain inverse with K2's Dinv) J
    against the JAX ``chol_inv_batched_upper`` (panel 64), float64 at 1e-10
    of max|.|, from G's lower triangle alone; R upper with R R^T = G."""
    rng = np.random.RandomState(M)
    S = _spd(rng, 3, M)
    Rj, Rij = pallas_linalg.chol_inv_batched_upper(jnp.asarray(S), panel=64)
    Lf, Dinv = cuda_linalg.chol_upper_blocked(_t(np.tril(S)))
    R = Lf.flip(-1, -2)
    Ri = cuda_linalg.tri_inv_blocked(Lf, Dinv).flip(-1, -2)
    _close(R, Rj, 1e-10)
    _close(Ri, Rij, 1e-10)
    assert (np.tril(R.numpy(), -1) == 0).all()
    _close(R.numpy() @ np.swapaxes(R.numpy(), 1, 2), S, 1e-12)
    assert cuda_linalg.chol_inv_base_upper.launches == 0   # the CPU never


@pytest.mark.parametrize('M', [64, 96, 384])
def test_k2_dinv_inverts_the_diagonal_blocks(M):
    """Dinv[:, t] is the inverse of Lf's diagonal 32x32 block t, in K1's
    [B, M/32, 32, 32] layout, and Lf is K1's factor of J sym(G) J."""
    rng = np.random.RandomState(M + 1)
    S = _spd(rng, 2, M)
    Lf, Dinv = cuda_linalg.chol_upper_blocked(_t(np.tril(S)))
    assert Dinv.shape == (2, M // W, W, W)
    for t in range(M // W):
        blk = Lf[:, t * W:(t + 1) * W, t * W:(t + 1) * W].numpy()
        _close(Dinv[:, t].numpy() @ blk, np.broadcast_to(np.eye(W), blk.shape),
               1e-12)
    Lk, Dk = cuda_linalg.chol_factor_blocked(_t(S[:, ::-1, ::-1].copy()))
    torch.testing.assert_close(Lf, Lk, rtol=0, atol=0)
    torch.testing.assert_close(Dinv, Dk, rtol=0, atol=0)


@pytest.mark.parametrize('M', [64, 160])
def test_k2_reads_only_the_lower_triangle(M):
    """Garbage above G's diagonal, inside the 8x8 diagonal sub-blocks too,
    changes nothing, bit for bit: K2's factor and Dinv, the base case
    ``chol_inv_base_upper`` (K2 then K3) and the solve on the K2 route."""
    rng = np.random.RandomState(M + 2)
    S = _spd(rng, 2, M)
    dirty, clean = _t(_dirty(rng, S)), _t(np.tril(S))
    for a, b in zip(cuda_linalg.chol_upper_blocked(dirty),
                    cuda_linalg.chol_upper_blocked(clean)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(cuda_linalg.chol_inv_base_upper(dirty),
                    cuda_linalg.chol_inv_base_upper(clean)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    X = _t(rng.randn(2, 5, M))
    torch.testing.assert_close(
        cuda_linalg.chol_right_solve_reversed(dirty, X),
        cuda_linalg.chol_right_solve_reversed(clean, X), rtol=0, atol=0)


def test_k2_route_equals_k1_on_the_reversed_matrix():
    """The solve by K2 (the route) and by K1 on J G J built first (the
    route it replaced at M <= 1024, which the card run compares with) are
    bit-equal: K2 runs K1's arithmetic on its reversed reads."""
    rng = np.random.RandomState(4)
    S = _spd(rng, 2, 128)
    G, X = _t(_dirty(rng, S)), _t(np.tril(rng.randn(2, 128, 128)))
    Lf, Dinv = cuda_linalg.chol_factor_blocked(
        cuda_linalg.reversed_sym_from_tril(G))
    Lfinv = cuda_linalg.tri_inv_blocked(Lf, Dinv)
    torch.testing.assert_close(
        cuda_linalg.chol_right_solve_reversed(G, X),
        X @ Lfinv.flip(-1, -2).transpose(-1, -2), rtol=0, atol=0)
    assert cuda_linalg.upper_route(128) == ('upper', None)


def test_k2_non_pd_is_nan_in_its_element_only():
    """A non-PD element gives NaN in its own factor and inverse; the
    others are finite and equal to their factor alone."""
    rng = np.random.RandomState(3)
    S = _spd(rng, 4, 96)
    S[2] = -np.eye(96)
    Lf, Dinv = cuda_linalg.chol_upper_blocked(_t(S))
    for out in (Lf, Dinv, cuda_linalg.tri_inv_blocked(Lf, Dinv)):
        assert not torch.isfinite(out[2]).all()
        assert torch.isfinite(out[[0, 1, 3]]).all()
    torch.testing.assert_close(
        Lf[[0, 1, 3]], cuda_linalg.chol_upper_blocked(_t(S[[0, 1, 3]]))[0],
        rtol=0, atol=0)


def test_upper_plan_owns_every_row_once_within_shared_memory():
    """For every M % 32 == 0 up to 2048 and every cluster size the
    launcher may take there: each tile row belongs to exactly one block
    (row 0 to the chain's, the others to a worker, cyclically), the slots
    of a worker's rows are 0, 1, ... and fit its ``rows``, and a block's
    shared memory fits 232,448 bytes."""
    for M in range(W, cuda_linalg.UPPER_MAX_M + 1, W):
        n = M // W
        sizes = cuda_linalg.upper_clusters(M)
        assert sizes and sizes[0] == (16 if M >= 512 else 8)
        assert sizes == sorted(sizes, reverse=True)
        for cluster in sizes:
            plan = cuda_linalg.upper_plan(M, cluster)
            assert plan['smem_bytes'] <= cuda_linalg.SMEM_BYTES
            assert len(plan['owner']) == len(plan['slot']) == n
            assert plan['owner'][0] == 0
            for b in range(1, cluster):
                mine = [i for i in range(1, n) if plan['owner'][i] == b]
                assert [plan['slot'][i] for i in mine] == list(range(len(mine)))
                assert len(mine) <= plan['rows']
            assert all(1 <= o < cluster for o in plan['owner'][1:])
    assert cuda_linalg.upper_clusters(2048) == [16, 8]
    assert cuda_linalg.upper_plan(2048, 4)['smem_bytes'] > cuda_linalg.SMEM_BYTES
    assert cuda_linalg.upper_plan(1088, 16)['smem_bytes'] == 105_984


# The kernel's loops over a worker's tiles in panel k, in Python
# (chol_upper_cluster_kernel in csrc/chol_inv.cu, line for line).


def _first_owned(j, rb, nw):
    return j + ((rb - (j - 1)) % nw + nw) % nw


def _owned_from(j, n, rb, nw):
    f = _first_owned(j, rb, nw)
    return (n - 1 - f) // nw + 1 if f < n else 0


def _warp_tiles(n, nw, rb, k, warp, warps=8):
    """(column tiles, triangle tiles) that worker rb's warp downdates in
    panel k, in the order it visits them."""
    d = k + 1
    f = _first_owned(d + 1, rb, nw)
    ncol = _owned_from(d + 1, n, rb, nw)
    cols = [(f + c * nw, d) for c in range(warp, ncol, warps)]
    ntri = sum(_owned_from(j, n, rb, nw) for j in range(d + 1, n))

    def share(w):
        return (ncol + ntri - w + warps - 1) // warps - \
            (ncol - w + warps - 1) // warps
    skip = sum(share(w) for w in range(warp))
    todo = share(warp)
    j = d + 1
    while todo > 0 and skip >= _owned_from(j, n, rb, nw):
        skip -= _owned_from(j, n, rb, nw)
        j += 1
    i = _first_owned(j, rb, nw) + skip * nw
    tri = []
    while todo > 0:
        while i >= n:
            j += 1
            i = _first_owned(j, rb, nw)
        tri.append((i, j))
        todo -= 1
        i += nw
    return cols, tri


@pytest.mark.parametrize('M', [64, 96, 384, 1088, 2048])
def test_k2_schedule_downdates_each_tile_once_by_its_row_owner(M):
    """In every panel k, each trailing tile (i, j), i >= j > k, other than
    the diagonal tile the chain takes, is downdated by exactly one warp,
    of the block that owns row i; the column tiles (i, k+1) come first,
    a warp each in turn; the warps of a block differ by at most one tile;
    and a warp's triangle tiles run column by column."""
    n = M // W
    for cluster in cuda_linalg.upper_clusters(M):
        nw = cluster - 1
        plan = cuda_linalg.upper_plan(M, cluster)
        for k in range(n - 1):
            d = k + 1
            seen = []
            for rb in range(nw):
                loads = []
                for warp in range(8):
                    cols, tri = _warp_tiles(n, nw, rb, k, warp)
                    assert all(j == d for _, j in cols)
                    assert [j for _, j in tri] == sorted(j for _, j in tri)
                    assert all(plan['owner'][i] == rb + 1 for i, _ in cols + tri)
                    seen += cols + tri
                    loads.append(len(cols) + len(tri))
                assert max(loads) - min(loads) <= 1
            want = [(i, j) for i in range(d, n) for j in range(d, i + 1)
                    if (i, j) != (d, d)]
            assert sorted(seen) == want


def _emulate_k2(G, cluster):
    """K2's data flow in numpy, tile by tile, from G's lower triangle:
    J G J written to the working matrix, tile (0, 0) factored, panel 0
    solved by the row owners into their buffer 0, then per panel k the
    chain's tile d = k+1, each worker's tiles as ``_warp_tiles`` lists
    them with panel rows read from buffer k % 2 of their owners, and the
    column tiles solved into buffer d % 2.  Returns Lf."""
    M = G.shape[0]
    n, nw = M // W, cluster - 1
    plan = cuda_linalg.upper_plan(M, cluster)
    low = np.tril(G)
    sym = low + np.tril(low, -1).T
    on_or_below = np.kron(np.tril(np.ones((n, n))), np.ones((W, W))) > 0
    L = np.where(on_or_below, sym[::-1, ::-1], 0.0)

    def T(i, j):
        return slice(W * i, W * i + W), slice(W * j, W * j + W)
    panels = {}
    L[T(0, 0)] = np.linalg.cholesky(L[T(0, 0)])
    for rb in range(nw):
        for c in range(_owned_from(1, n, rb, nw)):
            i = rb + 1 + c * nw
            L[T(i, 0)] = np.linalg.solve(L[T(0, 0)], L[T(i, 0)].T).T
            panels[(rb + 1, 0, c)] = L[T(i, 0)].copy()
    for k in range(n - 1):
        d = k + 1
        ldd = L[T(d, d)] - L[T(d, k)] @ L[T(d, k)].T
        L[T(d, d)] = np.linalg.cholesky(ldd)

        def prow(j):
            return panels[(plan['owner'][j], k % 2, plan['slot'][j])]
        held = []
        for rb in range(nw):
            for warp in range(8):
                cols, tri = _warp_tiles(n, nw, rb, k, warp)
                for i, j in cols + tri:
                    mine = panels[(rb + 1, k % 2, plan['slot'][i])]
                    L[T(i, j)] -= mine @ prow(j).T
                held += [(rb + 1, i) for i, _ in cols]
        for rank, i in held:
            L[T(i, d)] = np.linalg.solve(L[T(d, d)], L[T(i, d)].T).T
            panels[(rank, d % 2, plan['slot'][i])] = L[T(i, d)].copy()
    return L


@pytest.mark.parametrize('M,cluster', [(32, 8), (64, 8), (96, 4), (384, 4),
                                       (384, 8), (416, 16), (640, 16)])
def test_k2_data_flow_emulated_matches_plain(M, cluster):
    """The kernel's data flow (two panel buffers a block, each row's panel
    tile kept by its owner and read by the others from the buffer of the
    current panel) gives the plain version's factor, float64 to 1e-12 of
    max|.|, with garbage above G's diagonal."""
    rng = np.random.RandomState(M + cluster)
    S = _spd(rng, 1, M)[0]
    Lf = _emulate_k2(_dirty(rng, S), cluster)
    _close(Lf, cuda_linalg.chol_upper_blocked_plain(_t(np.tril(S))[None])[0][0],
           1e-12)


def test_natgrad_solve_m1088_upper_route_matches_library():
    """Y = W R^-T at M = 1088, B = 1 on the K2 route (float32, plain
    versions on the CPU: one K2 and one K3) against the float64 library
    factor of the reversed G and its triangular solve, within 2e-4 of
    max|.|."""
    assert cuda_linalg.upper_route(1088) == ('upper', None)
    assert optim.natgrad_route(torch.float32, 1088) == 'upper'
    rng = np.random.RandomState(10)
    M = 1088
    S = _spd(rng, 1, M, jitter=5.0)
    X = np.tril(rng.randn(1, M, M))
    Y = cuda_linalg.chol_right_solve_upper(_t(np.tril(S).astype(np.float32)),
                                           _t(X.astype(np.float32)))
    R = np.linalg.cholesky(S[:, ::-1, ::-1])[:, ::-1, ::-1]
    Yref = np.linalg.solve(R, np.swapaxes(X, 1, 2)).swapaxes(1, 2)
    assert Y.dtype == torch.float32 and Y.shape == X.shape
    _close(Y.numpy(), Yref, 2e-4)
