"""The plain versions of the redesigned K1 (the whole blocked Cholesky
factor, ``chol_factor_blocked``) and K3 (the whole triangular inverse by
column strips, ``tri_inv_blocked``) on the CPU: against the JAX drivers
(Pallas base cases in interpret mode) and numpy's float64 factor and
inverse at the main paths' shapes, their NaN isolation, and the panel's
edge cases.  Inputs are numpy arrays from a seeded RandomState handed to
both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.ops import pallas_linalg

from deepcgp_tpu_torch.ops import cuda_linalg, linalg


@pytest.fixture(scope='module', autouse=True)
def _compiled_pallas():
    """Each Pallas base case through one ``jax.jit`` in interpret mode, so
    that a shape is traced once; the kernels and drivers stay the JAX
    package's own."""
    mp = pytest.MonkeyPatch()
    for name in ('chol_inv_base', 'tri_inv_base'):
        fn = jax.jit(functools.partial(getattr(pallas_linalg, name),
                                       interpret=True))
        mp.setattr(pallas_linalg, name,
                   lambda D, interpret=None, _fn=fn: _fn(D))
    yield
    mp.undo()


def _spd(rng, B, M, jitter=2.0):
    A = rng.randn(B, M, M)
    return A @ np.swapaxes(A, -1, -2) / M + jitter * np.eye(M)


def _close(a, b, tol):
    """max |a - b| within ``tol`` of max |b|."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def _jax_pair(S, M):
    """The JAX package's (L, L^-1) of S by the route its ``_chol_inv_impl``
    takes: the blocked driver up to M = 512, the factor-only driver plus
    block doubling above (at panel and block 64, so that every base case
    is the one 64-wide kernel, traced once)."""
    if M <= 512:
        return pallas_linalg.chol_inv_batched(jnp.asarray(S))
    L = pallas_linalg.chol_factor_batched(jnp.asarray(S), panel=64)
    return L, pallas_linalg.tri_inv_doubling(L, block=64)


CASES = [(64, 1), (64, 3), (384, 1), (384, 3), (1024, 1)]


@pytest.mark.parametrize('dtype,tol', [(np.float64, 1e-10),
                                       (np.float32, 2e-5)])
@pytest.mark.parametrize('M,B', CASES)
def test_blocked_route_matches_jax_and_float64(M, B, dtype, tol):
    """``chol_inv_batched`` (K1 then K3 with K1's diagonal inverses)
    against the JAX drivers and numpy's float64 result, each to ``tol`` of
    the largest magnitude: 1e-10 in float64, 2e-5 in float32 (both sides
    round the same block identities in other orders).  The factor is
    lower-triangular, and so is its inverse."""
    S = _spd(np.random.RandomState(M + B), B, M).astype(dtype)
    L, Li = cuda_linalg.chol_inv_batched(torch.as_tensor(S))
    Lj, Lij = _jax_pair(S, M)
    Lr = np.linalg.cholesky(S.astype(np.float64))
    for ours, theirs, ref in ((L, Lj, Lr), (Li, Lij, np.linalg.inv(Lr))):
        _close(ours.numpy(), theirs, tol)
        _close(ours.numpy(), ref, tol)
        assert (np.triu(ours.numpy(), 1) == 0).all()


def test_blocked_route_matches_float64_m1024_batch3():
    """The [3, 1024, 1024] float32 route against numpy's float64 factor
    and inverse, 2e-5 of the largest magnitude."""
    S = _spd(np.random.RandomState(11), 3, 1024)
    L, Li = cuda_linalg.chol_inv_batched(
        torch.as_tensor(S, dtype=torch.float32))
    Lr = np.linalg.cholesky(S)
    _close(L.numpy(), Lr, 2e-5)
    _close(Li.numpy(), np.linalg.inv(Lr), 2e-5)


@pytest.mark.parametrize('M,B', [(384, 3), (1024, 1)])
def test_factor_and_inverse_apart_match_jax(M, B):
    """``chol_factor_batched`` (K1 alone) against the JAX driver of the
    same name, and the inverse by K3 alone (substituting on its diagonal
    blocks: ``tri_inv_doubling`` at M = 1024, against the JAX driver too,
    ``tri_inv_base`` at 384), float64, 1e-10 of the largest magnitude.
    Both JAX drivers run at panel and block 64."""
    S = _spd(np.random.RandomState(M), B, M)
    L = cuda_linalg.chol_factor_batched(torch.as_tensor(S), panel=64)
    _close(L, pallas_linalg.chol_factor_batched(jnp.asarray(S), panel=64),
           1e-10)
    if M == 1024:
        X = cuda_linalg.tri_inv_doubling(L, block=64)
        _close(X, pallas_linalg.tri_inv_doubling(jnp.asarray(L.numpy()),
                                                 block=64), 1e-10)
    else:
        X = cuda_linalg.tri_inv_base(L)
    _close(X, np.linalg.inv(L.numpy()), 1e-10)


def test_inverse_with_and_without_k1_inverses_agree():
    """K3's plain version with K1's diagonal-block inverses and with its
    own substitution give the same L^-1 (float64, 1e-12 of max|.|); the
    strict upper triangle of L is not read."""
    S = _spd(np.random.RandomState(3), 3, 160)             # 5 panels
    L, Dinv = cuda_linalg.chol_factor_blocked_plain(torch.as_tensor(S))
    dirty = L + torch.triu(torch.full_like(L, 1e6), 1)
    X1 = cuda_linalg.tri_inv_blocked_plain(L, Dinv)
    X2 = cuda_linalg.tri_inv_blocked_plain(dirty)
    _close(X1, X2, 1e-12)
    _close(X1, np.linalg.inv(L.numpy()), 1e-12)


@pytest.mark.parametrize('M,w', [(32, 32), (64, 64), (96, 32), (160, 32)])
def test_panel_edge_cases(M, w):
    """w = M is the unblocked elimination itself (bit for bit); M/w odd
    (3 and 5 panels) factors and inverts to 1e-12 of float64."""
    S = torch.as_tensor(_spd(np.random.RandomState(M), 2, M))
    L, Dinv = cuda_linalg.chol_factor_blocked_plain(S, w)
    X = cuda_linalg.tri_inv_blocked_plain(L, Dinv, w)
    if w == M:
        L0, Li0 = cuda_linalg.chol_inv_base_plain(S)
        torch.testing.assert_close(L, L0, rtol=0, atol=0)
        torch.testing.assert_close(Dinv[:, 0], Li0, rtol=0, atol=0)
    Lr = np.linalg.cholesky(S.numpy())
    _close(L, Lr, 1e-12)
    _close(X, np.linalg.inv(Lr), 1e-12)
    assert Dinv.shape == (2, M // w, w, w)


def test_non_pd_gives_nan_in_its_element_only():
    """A non-PD element of a [3, 384, 384] float32 batch gives NaN in its
    factor and inverse; the other two stay finite and right; a zero pivot
    of a factor gives a non-finite inverse in its element only."""
    S = _spd(np.random.RandomState(4), 3, 384).astype(np.float32)
    S[1] = -np.eye(384)
    L, Li = cuda_linalg.chol_inv_batched(torch.as_tensor(S))
    for a in (L, Li):
        assert not torch.isfinite(a[1]).all()
        assert torch.isfinite(a[[0, 2]]).all()
    _close(L[2].numpy(), np.linalg.cholesky(S[2].astype(np.float64)), 2e-5)
    bad = L[[0, 2]].clone()
    bad[1, 100, 100] = 0.0
    X = cuda_linalg.tri_inv_blocked_plain(bad)
    assert torch.isfinite(X[0]).all() and not torch.isfinite(X[1]).all()


def test_chol_with_inv_routes_m1024_only_up_to_the_kernels():
    """M = 1024 takes the kernels' route; M = 2048 (beyond K1's and K3's
    largest matrix) the library's."""
    assert linalg._bigchol_slice(torch.zeros(1024, 1024))
    assert not linalg._bigchol_slice(torch.zeros(2048, 2048))
    assert not linalg._bigchol_slice(torch.zeros(1024, 1024,
                                                 dtype=torch.float64))
