"""The PyTorch port's NatGrad and M=1024 pieces against the JAX package on
the CPU: the plain versions of the upper base case (K2 then K3) and K3
(triangular inverse) against the Pallas kernels in interpret mode, the
upper drivers, the factor-only driver and the block-doubling inverse, the
M > 512 route of ``chol_with_inv``, ``natgrad_update`` on both routes,
layer stacking, backoff and the gamma schedule.  Inputs are numpy arrays
from a seeded RandomState handed to both sides; float64 unless a test says
otherwise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.ops import pallas_linalg
from deepcgp_tpu.training import optim as joptim

from deepcgp_tpu_torch.ops import cuda_linalg, linalg
from deepcgp_tpu_torch.training import optim


@pytest.fixture(scope='module', autouse=True)
def _compiled_pallas():
    """The JAX drivers call their Pallas base cases eagerly, and interpret
    mode re-traces the unrolled 64-step kernel on every call (about 3 s
    each).  Route each base case through one ``jax.jit`` so that a shape is
    traced and compiled once; the kernels and the drivers stay the JAX
    package's own."""
    mp = pytest.MonkeyPatch()
    for name in ('chol_inv_base', 'chol_inv_base_upper', 'tri_inv_base'):
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


# ------------------------------------------------------------ K2


def test_chol_inv_base_upper_plain_matches_pallas():
    """The upper base case (K2 then K3, here their plain versions: K1's
    block order on the reversed matrix) against the Pallas kernel,
    [3, 64, 64], float64 at rtol 1e-10 (atol 1e-13)."""
    S = _spd(np.random.RandomState(0), 3, 64)
    Rj, Rij = pallas_linalg.chol_inv_base_upper(jnp.asarray(S))
    R, Ri = cuda_linalg.chol_inv_base_upper(_t(S))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(Ri.numpy(), np.asarray(Rij), rtol=1e-10, atol=1e-13)
    assert (np.tril(R.numpy(), -1) == 0).all()
    np.testing.assert_allclose(R.numpy() @ np.swapaxes(R.numpy(), 1, 2), S,
                               rtol=0, atol=1e-12)
    assert cuda_linalg.chol_inv_base_upper.launches == 0   # the CPU never launches


def test_chol_inv_base_upper_non_pd_is_nan_in_its_element_only():
    S = _spd(np.random.RandomState(1), 4, 16)
    S[2] = -np.eye(16)
    for out in cuda_linalg.chol_inv_base_upper(_t(S)):
        assert not torch.isfinite(out[2]).all()
        assert torch.isfinite(out[[0, 1, 3]]).all()


def test_chol_inv_base_reads_both_triangles():
    """K1 reads the whole matrix, as the JAX kernel does: garbage above the
    diagonal changes the factor, and the symmetric matrix of the lower
    triangle restores it.  The upper base case (K2) reads the lower
    triangle only: the same garbage changes nothing, bit for bit."""
    S = _spd(np.random.RandomState(2), 2, 16)
    dirty = np.tril(S) + np.triu(np.random.RandomState(3).randn(2, 16, 16), 1)
    base = cuda_linalg.chol_inv_base
    clean = base(_t(S))[0].numpy()
    assert np.abs(base(_t(dirty))[0].numpy() - clean).max() > 1e-3
    sym = np.tril(dirty) + np.swapaxes(np.tril(dirty, -1), 1, 2)
    np.testing.assert_array_equal(base(_t(sym))[0].numpy(), clean)
    for a, b in zip(cuda_linalg.chol_inv_base_upper(_t(dirty)),
                    cuda_linalg.chol_inv_base_upper(_t(S))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize('M', [128, 256])
def test_upper_drivers_match_jax(M):
    """``chol_inv_batched_upper`` and ``chol_right_solve_upper`` against the
    JAX drivers (Pallas base cases in interpret mode) at panel 64, float64,
    to 1e-10 of each result's largest magnitude (the drivers' products sum
    in other orders)."""
    rng = np.random.RandomState(4)
    S = _spd(rng, 3, M)
    X = rng.randn(3, 5, M)
    Rj, Rij = pallas_linalg.chol_inv_batched_upper(jnp.asarray(S), panel=64)
    Yj = pallas_linalg.chol_right_solve_upper(jnp.asarray(S), jnp.asarray(X),
                                              panel=64)
    R, Ri = cuda_linalg.chol_inv_batched_upper(_t(S), panel=64)
    Y = cuda_linalg.chol_right_solve_upper(_t(S), _t(X), panel=64)
    _close(R, Rj, 1e-10)
    _close(Ri, Rij, 1e-10)
    _close(Y, Yj, 1e-10)
    assert (np.tril(R.numpy(), -1) == 0).all() and (np.tril(Ri.numpy(), -1) == 0).all()


@pytest.mark.parametrize('M,panel', [(64, 64), (256, 64)])
def test_upper_drivers_read_only_tril(M, panel):
    """The upper drivers read only the lower triangle of A, through K2 on
    the diagonal blocks and the lower block rows in the panel solves:
    garbage above the diagonal changes nothing, bit for
    bit (the input of tests/test_pallas_linalg.py's test of the JAX
    drivers)."""
    rng = np.random.RandomState(7)
    S = _spd(rng, 3, M)
    dirty = np.tril(S) + np.triu(rng.randn(3, M, M) * 1e6, 1)
    X = _t(rng.randn(3, M, M))
    clean = cuda_linalg.chol_right_solve_upper(_t(S), X, panel=panel)
    torch.testing.assert_close(
        cuda_linalg.chol_right_solve_upper(_t(dirty), X, panel=panel), clean,
        rtol=0, atol=0)
    for a, b in zip(cuda_linalg.chol_inv_batched_upper(_t(S), panel=panel),
                    cuda_linalg.chol_inv_batched_upper(_t(dirty), panel=panel)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


# ------------------------------------------------------------ K3 and M > 512


def test_tri_inv_base_plain_matches_pallas():
    """K3's plain version against the Pallas kernel, [12, 64, 64] lower
    factors, float64 at rtol 1e-10."""
    L = np.linalg.cholesky(_spd(np.random.RandomState(5), 12, 64))
    Xj = pallas_linalg.tri_inv_base(jnp.asarray(L))
    X = cuda_linalg.tri_inv_base(_t(L))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=1e-10, atol=1e-13)
    assert cuda_linalg.tri_inv_base.launches == 0


def test_tri_inv_doubling_and_factor_match_jax():
    """``chol_factor_batched`` (panel 64) and ``tri_inv_doubling`` (block
    64) at [3, 256, 256] against the JAX drivers, float64, to 1e-10 of the
    largest magnitude; the factor is lower-triangular."""
    S = _spd(np.random.RandomState(6), 3, 256)
    Lj = pallas_linalg.chol_factor_batched(jnp.asarray(S), panel=64)
    L = cuda_linalg.chol_factor_batched(_t(S), panel=64)
    _close(L, Lj, 1e-10)
    assert (np.triu(L.numpy(), 1) == 0).all()
    Xj = pallas_linalg.tri_inv_doubling(jnp.asarray(L.numpy()), block=64)
    X = cuda_linalg.tri_inv_doubling(L, block=64)
    _close(X, Xj, 1e-10)
    with pytest.raises(ValueError):
        cuda_linalg.tri_inv_doubling(L[:, :192, :192], block=64)  # 3 blocks


def test_chol_with_inv_m1024_takes_the_big_route(monkeypatch):
    """float32 at M = 1024 goes to K1 (the whole blocked factor, one call)
    and K3 (the whole inverse, one call, with K1's diagonal-block
    inverses), and agrees with numpy's float64 factor and inverse to 2e-5
    of their largest magnitude (float32 on a well-conditioned matrix)."""
    calls = {'k1': 0, 'k3': 0}
    k1 = cuda_linalg.chol_factor_blocked_plain
    k3 = cuda_linalg.tri_inv_blocked_plain

    def count(name, fn):
        def wrapped(x, *a):
            calls[name] += 1
            assert x.shape == (1, 1024, 1024), x.shape
            return fn(x, *a)
        return wrapped

    monkeypatch.setattr(cuda_linalg, 'chol_factor_blocked_plain', count('k1', k1))
    monkeypatch.setattr(cuda_linalg, 'tri_inv_blocked_plain', count('k3', k3))
    S = _spd(np.random.RandomState(8), 1, 1024)[0]
    assert linalg._bigchol_slice(_t(S).float())
    L, Li = linalg.chol_with_inv(_t(S).float())
    Lr = np.linalg.cholesky(S)
    _close(L.numpy(), Lr, 2e-5)
    _close(Li.numpy(), np.linalg.inv(Lr), 2e-5)
    assert calls == {'k1': 1, 'k3': 1}


# ------------------------------------------------------------ natgrad_update


def _natgrad_inputs(rng, R, M, dtype):
    A = rng.randn(R, M, M)
    S = A @ np.swapaxes(A, -1, -2) / M + 5.0 * np.eye(M)
    return [x.astype(dtype) for x in (rng.randn(M, R), np.linalg.cholesky(S),
                                      rng.randn(M, R), rng.randn(R, M, M))]


def test_expectation_vjp_matches_autograd():
    """The factorization-free pullback of eta -> (mu, chol(S)) equals torch
    autograd through the factorizing map, and the JAX package's pullback
    (float64, rtol 1e-9)."""
    rng = np.random.RandomState(0)
    R, M = 3, 6
    A = rng.randn(R, M, M)
    S = A @ np.swapaxes(A, -1, -2) + 4.0 * np.eye(M)
    mu, dmu, dW = rng.randn(R, M), rng.randn(R, M), np.tril(rng.randn(R, M, M))
    eta1 = _t(mu).requires_grad_(True)
    eta2 = _t(S + mu[:, :, None] * mu[:, None, :]).requires_grad_(True)
    W = torch.linalg.cholesky(eta2 - eta1[:, :, None] * eta1[:, None, :])
    ref = torch.autograd.grad((eta1, W), (eta1, eta2), (_t(dmu), _t(dW)))
    got = optim._expectation_vjp(_t(mu), _t(np.linalg.cholesky(S)), _t(dmu), _t(dW))
    ref_j = joptim._expectation_vjp(*map(jnp.asarray, (mu, np.linalg.cholesky(S),
                                                       dmu, dW)))
    for a, b, c in zip(got, ref, ref_j):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-9, atol=1e-11)


def test_natgrad_update_f64_matches_jax():
    """The library route (float64): the port's ``natgrad_update`` and
    ``natgrad_update_theta`` against the JAX package's at rtol 1e-10, and
    the fused update against the theta round trip at the JAX tests' own
    1e-8; a step out of the PD cone is non-finite on every side."""
    args = _natgrad_inputs(np.random.RandomState(7), 3, 8, np.float64)
    for gamma in (1e-4, 1e-3, 1e-2):
        g = torch.tensor(gamma, dtype=torch.float64)
        ours = optim.natgrad_update(*map(_t, args), g)
        theta = optim.natgrad_update_theta(*map(_t, args), g)
        ref = joptim.natgrad_update(*map(jnp.asarray, args), jnp.asarray(gamma))
        ref_t = joptim.natgrad_update_theta(*map(jnp.asarray, args),
                                            jnp.asarray(gamma))
        for a, b in zip(ours + theta, ref + ref_t):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                       atol=1e-12)
        for a, b in zip(ours, theta):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8, atol=1e-10)
    for out in (optim.natgrad_update(*map(_t, args), torch.tensor(0.5)),
                optim.natgrad_update_theta(*map(_t, args), torch.tensor(0.5))):
        assert not torch.isfinite(out[1]).all()


@pytest.mark.parametrize('route', ['reversed', 'panels'])
def test_natgrad_update_f32_kernel_route_matches_jax(monkeypatch, route):
    """float32 with M % 32 == 0 takes a kernel route (G's lower triangle
    into K2 and K3 on the whole index-reversed G, 'reversed', or into the
    panel driver, 'panels', forced here at M = 128): against the JAX
    package forced through its Pallas branch (interpret mode) and against
    the theta round trip, at the JAX test's 2e-4 relative, 2e-5 absolute.
    M = 128: one K2 and one K3 per update, or two K2 + K3 base cases at
    panel 64."""
    monkeypatch.setenv('DEEPCGP_PALLAS_FORCE', '1')
    assert optim.natgrad_route(torch.float32, 128) == 'upper'
    if route == 'panels':
        monkeypatch.setattr(cuda_linalg, 'upper_route',
                            lambda M: ('panels', 64))
    calls = []
    for name in ('chol_upper_blocked_plain', 'chol_factor_blocked_plain',
                 'tri_inv_blocked_plain'):
        monkeypatch.setattr(
            cuda_linalg, name,
            lambda D, *a, _f=getattr(cuda_linalg, name), _n=name:
            calls.append((_n, tuple(D.shape))) or _f(D, *a))
    args = _natgrad_inputs(np.random.RandomState(11), 3, 128, np.float32)
    assert joptim._use_pallas_factor(jnp.float32, 128)
    for gamma in (1e-3, 1e-2):
        g = torch.tensor(gamma, dtype=torch.float32)
        mu, W = optim.natgrad_update(*map(_t, args), g)
        assert W.dtype == torch.float32 and torch.isfinite(W).all()
        mu_j, W_j = joptim.natgrad_update(*map(jnp.asarray, args),
                                          jnp.asarray(gamma, jnp.float32))
        mu_t, W_t = optim.natgrad_update_theta(*map(_t, args), g)
        for a, b in ((mu, mu_j), (W, W_j), (mu, mu_t), (W, W_t)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                       atol=2e-5)
    if route == 'panels':
        assert calls == [('chol_upper_blocked_plain', (3, 64, 64)),
                         ('tri_inv_blocked_plain', (3, 64, 64))] * 4
    else:
        assert calls == [('chol_upper_blocked_plain', (3, 128, 128)),
                         ('tri_inv_blocked_plain', (3, 128, 128))] * 2


def test_natgrad_kernel_route_non_pd_is_non_finite():
    """A G that leaves the PD cone gives a non-finite proposal on the K2
    route too: the backoff's only signal."""
    args = _natgrad_inputs(np.random.RandomState(12), 2, 64, np.float32)
    mu, W = optim.natgrad_update(*map(_t, args), torch.tensor(50.0))
    assert not (torch.isfinite(W).all() and torch.isfinite(mu).all())


def test_natgrad_layer_stacking_matches_per_layer_and_jax():
    """Two layers of the same (M, R) are updated in one stacked call: equal
    to per-layer updates (rtol 1e-9) and to the JAX package's stacked step
    (rtol 1e-10)."""

    class Layer:
        def __init__(self, q_mu, q_sqrt):
            self.q_mu, self.q_sqrt = q_mu, q_sqrt

        def replace(self, q_mu, q_sqrt):
            return Layer(q_mu, q_sqrt)

    rng = np.random.RandomState(2)
    M, R = 7, 3
    params, grads = [], []
    for _ in range(2):
        A = rng.randn(R, M, M)
        params.append((rng.randn(M, R),
                       np.linalg.cholesky(A @ np.swapaxes(A, -1, -2) + 3 * np.eye(M))))
        grads.append((0.01 * rng.randn(M, R), 0.01 * np.tril(rng.randn(R, M, M))))
    gamma = torch.tensor(0.1, dtype=torch.float64)
    new, sb, ok = optim.natgrad_step_with_backoff(
        [tuple(map(_t, p)) for p in params], [tuple(map(_t, g)) for g in grads],
        gamma, torch.tensor(0.0, dtype=torch.float64))
    assert bool(ok) and float(sb) == 0.0
    ref, _, ok_j = joptim.natgrad_step_with_backoff(
        tuple(Layer(*map(jnp.asarray, p)) for p in params),
        tuple(Layer(*map(jnp.asarray, g)) for g in grads),
        jnp.asarray(0.1), jnp.asarray(0.0))
    assert bool(ok_j)
    for p, g, (mu, W), r in zip(params, grads, new, ref):
        mu1, W1 = optim.natgrad_update(*map(_t, p + g), gamma)
        np.testing.assert_allclose(mu.numpy(), mu1.numpy(), rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(W.numpy(), W1.numpy(), rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(mu.numpy(), np.asarray(r.q_mu), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(W.numpy(), np.asarray(r.q_sqrt), rtol=1e-10, atol=1e-12)


def test_natgrad_backoff_on_non_finite_input():
    """A non-finite gradient makes the proposal non-finite: every layer
    keeps its values (q_sqrt as its lower triangle) and steps_back grows."""
    rng = np.random.RandomState(3)
    p = (_t(rng.randn(5, 2)), _t(np.linalg.cholesky(_spd(rng, 2, 5))))
    g = (_t(rng.randn(5, 2)) * float('nan'), _t(rng.randn(2, 5, 5)))
    new, sb, ok = optim.natgrad_step_with_backoff(
        [p], [g], torch.tensor(0.1, dtype=torch.float64),
        torch.tensor(2.0, dtype=torch.float64))
    assert not bool(ok) and float(sb) == 3.0
    torch.testing.assert_close(new[0][0], p[0], rtol=0, atol=0)
    torch.testing.assert_close(new[0][1], torch.tril(p[1]), rtol=0, atol=0)


@pytest.mark.parametrize('step,steps_back', [(0, 0.0), (250, 0.0), (1000, 2.0),
                                             (10 ** 6, 0.0)])
def test_gamma_schedule_matches_jax(step, steps_back):
    ours = optim.gamma_schedule(torch.tensor(step),
                                torch.tensor(steps_back, dtype=torch.float64), 0.001)
    ref = joptim.gamma_schedule(jnp.asarray(step), jnp.asarray(steps_back), 0.001)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-12)
