"""The NatGrad solve's route on the index-reversed matrix against the JAX
package on the CPU: ``cuda_linalg.chol_right_solve_reversed`` and
``chol_inv_batched_upper`` (K2 then K3 on G's lower triangle, here
through their plain versions) against the JAX upper drivers with their
Pallas base cases in interpret mode; its NaN isolation, its reading of
the lower triangle only, the dispatch of ``optim.natgrad_route`` and the
K2 route above K1's largest matrix.  Inputs are numpy arrays from a seeded RandomState
handed to both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.ops import pallas_linalg
from deepcgp_tpu.training import optim as joptim

from deepcgp_tpu_torch.ops import cuda_linalg
from deepcgp_tpu_torch.training import optim


@pytest.fixture(scope='module', autouse=True)
def _compiled_pallas():
    """Each Pallas base case through one ``jax.jit`` (interpret mode), so
    that a shape is traced once; the drivers stay the JAX package's."""
    mp = pytest.MonkeyPatch()
    for name in ('chol_inv_base_upper',):
        fn = jax.jit(functools.partial(getattr(pallas_linalg, name),
                                       interpret=True))
        mp.setattr(pallas_linalg, name,
                   lambda D, interpret=None, _fn=fn: _fn(D))
    yield
    mp.undo()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _spd(rng, B, M, jitter=2.0):
    A = rng.randn(B, M, M)
    return A @ np.swapaxes(A, -1, -2) / M + jitter * np.eye(M)


def _close(a, b, tol):
    """max |a - b| within ``tol`` of max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


@pytest.mark.parametrize('M', [128, 384])
@pytest.mark.parametrize('x_form', ['lower_square', 'general'])
def test_reversed_solve_matches_jax(M, x_form):
    """Y = X R^-T by the K2 route against the JAX
    ``chol_right_solve_upper`` (panel 64), float64 at 1e-10 of max|.|,
    with G passed as its lower triangle only (as ``natgrad_update`` builds
    it) and X either lower-triangular [B, M, M] (the NatGrad W) or a
    general [B, N, M] with N != M."""
    rng = np.random.RandomState(M)
    S = _spd(rng, 2, M)
    X = (np.tril(rng.randn(2, M, M)) if x_form == 'lower_square'
         else rng.randn(2, 7, M))
    Yj = pallas_linalg.chol_right_solve_upper(jnp.asarray(S), jnp.asarray(X),
                                              panel=64)
    Y = cuda_linalg.chol_right_solve_reversed(_t(np.tril(S)), _t(X))
    assert Y.shape == X.shape
    _close(Y, Yj, 1e-10)
    torch.testing.assert_close(
        cuda_linalg.chol_right_solve_upper(_t(np.tril(S)), _t(X)), Y,
        rtol=0, atol=0)


@pytest.mark.parametrize('M', [128, 384])
def test_reversed_factor_and_inverse_match_jax(M):
    """``chol_inv_batched_upper`` on the K2 route: R = J Lf J and
    R^-1 = J Lf^-1 J against the JAX driver's (R, R^-1), float64 at 1e-10
    of max|.|, both upper-triangular, with R R^T = A."""
    rng = np.random.RandomState(M + 1)
    S = _spd(rng, 3, M)
    Rj, Rij = pallas_linalg.chol_inv_batched_upper(jnp.asarray(S), panel=64)
    assert cuda_linalg.upper_route(M) == ('upper', None)
    R, Ri = cuda_linalg.chol_inv_batched_upper(_t(np.tril(S)))
    _close(R, Rj, 1e-10)
    _close(Ri, Rij, 1e-10)
    assert (np.tril(R.numpy(), -1) == 0).all()
    assert (np.tril(Ri.numpy(), -1) == 0).all()
    _close(R.numpy() @ np.swapaxes(R.numpy(), 1, 2), S, 1e-12)


def test_reversed_solve_non_pd_is_non_finite_in_its_element_only():
    """A G that is not PD gives a non-finite Y in its own batch element,
    and leaves the others finite and equal to their solve alone: NatGrad's
    backoff reads finiteness."""
    rng = np.random.RandomState(5)
    S = _spd(rng, 4, 64)
    S[2] = -np.eye(64)
    X = _t(np.tril(rng.randn(4, 64, 64)))
    Y = cuda_linalg.chol_right_solve_reversed(_t(S), X)
    assert not torch.isfinite(Y[2]).all()
    rest = [0, 1, 3]
    assert torch.isfinite(Y[rest]).all()
    torch.testing.assert_close(
        Y[rest], cuda_linalg.chol_right_solve_reversed(_t(S[rest]), X[rest]),
        rtol=0, atol=0)


def test_reversed_sym_from_tril_reads_lower_triangle_only():
    """J sym(A) J from the lower triangle alone: garbage above
    the diagonal changes nothing, bit for bit, and the result is the
    reversed symmetric matrix."""
    rng = np.random.RandomState(6)
    S = _spd(rng, 2, 96)
    dirty = np.tril(S) + np.triu(rng.randn(2, 96, 96) * 1e6, 1)
    Gr = cuda_linalg.reversed_sym_from_tril(_t(dirty))
    torch.testing.assert_close(Gr, _t(S).flip(-1, -2), rtol=0, atol=0)
    torch.testing.assert_close(Gr, cuda_linalg.reversed_sym_from_tril(
        _t(np.tril(S))), rtol=0, atol=0)
    assert torch.equal(Gr, Gr.transpose(-1, -2))


@pytest.mark.parametrize('dtype,M,route', [
    (torch.float32, 32, 'upper'), (torch.float32, 96, 'upper'),
    (torch.float32, 384, 'upper'), (torch.float32, 1024, 'upper'),
    (torch.float32, 1088, 'upper'), (torch.float32, 1056, 'upper'),
    (torch.float32, 100, 'library'), (torch.float64, 384, 'library'),
    (torch.float64, 1024, 'library'), (torch.float32, 2048, 'upper'),
    (torch.float32, 3072, 'panels'), (torch.float32, 2080, 'library'),
    (torch.float64, 1088, 'library')])
def test_natgrad_route_dispatch(dtype, M, route):
    """One function picks the NatGrad solve's route: K2 and K3 for float32
    M % 32 == 0 up to 2048, the panel driver around them for float32
    M % 64 == 0 above 2048, the library for the rest and for float64."""
    assert optim.natgrad_route(dtype, M) == route


def test_upper_route_and_panel_by_shape():
    """The upper drivers' own route follows K2's shape contract, and the
    panel driver's panel (the largest power of two up to 2048 that divides
    M) divides M."""
    assert cuda_linalg.upper_route(1024) == ('upper', None)
    assert cuda_linalg.upper_route(96) == ('upper', None)
    assert [cuda_linalg.upper_route(M) for M in (1088, 1152, 1216, 2048)] == \
        [('upper', None)] * 4
    assert cuda_linalg.upper_route(1056) == ('upper', None)
    assert cuda_linalg.upper_route(48) is None
    assert [cuda_linalg.upper_route(M) for M in (2112, 3072, 4096, 6144)] == \
        [('panels', 64), ('panels', 1024), ('panels', 2048), ('panels', 2048)]
    assert cuda_linalg.upper_route(2080) is None


def test_natgrad_update_panels_above_k1_matches_library(monkeypatch):
    """float32 M = 1088, above K1's largest matrix, takes K2 on the whole
    matrix (one K2 call, no panel loop), and the update agrees with the
    float64 library route to 2e-4 of max|.|."""
    rng = np.random.RandomState(9)
    M, R = 1088, 1
    A = rng.randn(R, M, M)
    S = A @ np.swapaxes(A, -1, -2) / M + 5.0 * np.eye(M)
    args = [rng.randn(M, R), np.linalg.cholesky(S), rng.randn(M, R),
            rng.randn(R, M, M)]
    calls = []
    plain = cuda_linalg.chol_upper_blocked_plain
    monkeypatch.setattr(cuda_linalg, 'chol_upper_blocked_plain',
                        lambda D: calls.append(tuple(D.shape)) or plain(D))
    g = 1e-3
    mu, W = optim.natgrad_update(*[_t(a.astype(np.float32)) for a in args],
                                 torch.tensor(g, dtype=torch.float32))
    mu64, W64 = optim.natgrad_update(*map(_t, args),
                                     torch.tensor(g, dtype=torch.float64))
    assert calls == [(R, M, M)]
    assert torch.isfinite(W64).all() and torch.isfinite(mu64).all()
    _close(W.double(), W64, 2e-4)
    _close(mu.double(), mu64, 2e-4)


@pytest.mark.parametrize('M', [96, 384])
def test_natgrad_update_f32_reversed_route_matches_jax(monkeypatch, M):
    """``natgrad_update`` on the K2 route at float32 (M = 96, which
    the JAX package sends to its library branch, and M = 384, which it
    sends through its Pallas branch when forced) against the JAX update
    at the JAX test's 2e-4 relative, 2e-5 absolute."""
    monkeypatch.setenv('DEEPCGP_PALLAS_FORCE', '1')
    rng = np.random.RandomState(M)
    R = 2
    A = rng.randn(R, M, M)
    S = A @ np.swapaxes(A, -1, -2) / M + 5.0 * np.eye(M)
    args = [x.astype(np.float32) for x in (
        rng.randn(M, R), np.linalg.cholesky(S), rng.randn(M, R),
        rng.randn(R, M, M))]
    assert optim.natgrad_route(torch.float32, M) == 'upper'
    assert joptim._use_pallas_factor(jnp.float32, M) == (M % 64 == 0)
    g = 1e-2
    mu, W = optim.natgrad_update(*map(_t, args), torch.tensor(g))
    mu_j, W_j = joptim.natgrad_update(*map(jnp.asarray, args),
                                      jnp.asarray(g, jnp.float32))
    for a, b in ((mu, mu_j), (W, W_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
