"""The port's full-covariance conditional and sampling against the JAX
package on the CPU, float64: ``multi_output_conditional(full_cov=True)``
white and not, with and without q_sqrt, and its diagonal floor on an
ill-conditioned downdate; ``MultiOutputConvKernel.Kuf`` / ``Kff``; the
blocked ``ConvKernel.K``, bit-equal to its one-block form; both layers'
``conditional_mean_var(full_cov=True)`` and ``sample_from_conditional``
on the same standard normals; and the upper base case's identity padding
(the card's route for a block that is not a multiple of 32) against the
unpadded plain version and the JAX upper base case."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models import dgp as jdgp
from deepcgp_tpu.models.base_kernels import RBF as JRBF
from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.models.conv_kernels import (ConvKernel as JConvKernel,
                                             MultiOutputConvKernel as JMOK)
from deepcgp_tpu.models.views import FullView as JFullView
from deepcgp_tpu.ops import pallas_linalg
from deepcgp_tpu.ops.conditional import multi_output_conditional as jcond

from deepcgp_tpu_torch.models.base_kernels import RBF
from deepcgp_tpu_torch.models.conv_kernels import (ConvKernel,
                                                   MultiOutputConvKernel,
                                                   gram_block_rows)
from deepcgp_tpu_torch.models.views import FullView
from deepcgp_tpu_torch.ops import cuda_linalg
from deepcgp_tpu_torch.ops.conditional import multi_output_conditional

from test_torch_training import port_of

RTOL = 1e-9


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _spd(rng, *shape):
    *b, n = shape
    A = rng.randn(*b, n, n)
    return A @ np.swapaxes(A, -1, -2) / n + 0.5 * np.eye(n)


def _close(a, b, what=''):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=RTOL,
                               atol=RTOL * np.abs(b).max(), err_msg=what)


@pytest.mark.parametrize('white', [False, True], ids=['nonwhite', 'white'])
@pytest.mark.parametrize('with_q', [False, True], ids=['no_q', 'q_sqrt'])
def test_full_cov_conditional_matches_jax(white, with_q):
    rng = np.random.RandomState(2 * white + with_q)
    P, N, M, R = 3, 5, 7, 2
    Kmn = rng.randn(P, N, M)
    Knn = _spd(rng, P, N) + 3.0 * np.eye(N)
    Lm = np.linalg.cholesky(_spd(rng, M))
    Lm_inv = np.linalg.inv(Lm)
    f = rng.randn(M, R)
    q = np.tril(rng.randn(R, M, M)) if with_q else None
    mj, vj = jcond(jnp.asarray(Kmn), None, jnp.asarray(Knn), jnp.asarray(f),
                   full_cov=True, q_sqrt=None if q is None else jnp.asarray(q),
                   white=white, Lm=jnp.asarray(Lm), Lm_inv=jnp.asarray(Lm_inv),
                   layout='pnm')
    m, v = multi_output_conditional(
        _t(Kmn), _t(Knn), _t(f), Lm_inv=_t(Lm_inv),
        q_sqrt=None if q is None else _t(q), white=white, full_cov=True)
    assert tuple(v.shape) == (R, P, N, N)
    _close(m, mj, 'fmean')
    _close(v, vj, 'fvar')
    # The diagonal branch is the full covariance's diagonal.
    _, vd = multi_output_conditional(
        _t(Kmn), _t(np.diagonal(Knn, axis1=1, axis2=2)), _t(f),
        Lm_inv=_t(Lm_inv), q_sqrt=None if q is None else _t(q), white=white)
    _close(vd, np.diagonal(v.numpy(), axis1=-2, axis2=-1), 'diag')


def test_full_cov_diagonal_floor_matches_jax():
    """tests/test_numerics_core.py's doctored downdate: Kmm = I, so A is
    Kmn's rows, and Knn's diagonal sits 1e-6 below A A^T's while its
    off-diagonal entries sit 0.3 above.  The diagonal is floored at 0,
    the off-diagonal entries keep the downdate, as in JAX."""
    rng = np.random.RandomState(5)
    P, M, N = 2, 4, 3
    Kmn = rng.randn(P, N, M)
    eye = np.eye(N)
    Knn = np.einsum('pnm,pkm->pnk', Kmn, Kmn) - 1e-6 * eye + 0.3 * (1 - eye)
    f = np.zeros((M, 1))
    _, vj = jcond(jnp.asarray(Kmn), None, jnp.asarray(Knn), jnp.asarray(f),
                  full_cov=True, Lm=jnp.eye(M), Lm_inv=jnp.eye(M),
                  layout='pnm')
    _, v = multi_output_conditional(_t(Kmn), _t(Knn), _t(f),
                                    Lm_inv=torch.eye(M, dtype=torch.float64),
                                    full_cov=True)
    v = v.numpy()
    np.testing.assert_allclose(v, np.asarray(vj), rtol=0, atol=1e-14)
    assert (np.diagonal(v, axis1=-2, axis2=-1) >= 0).all()
    np.testing.assert_allclose(v[0] * (1 - eye), 0.3 * (1 - eye) + 0 * v[0],
                               atol=1e-12)


def test_kuf_kff_match_jax():
    rng = np.random.RandomState(1)
    PNL, Z = rng.randn(4, 6, 12), rng.randn(5, 12)
    jk = JMOK(base_kernel=JRBF.create(1.3, 2.1, dtype=jnp.float64),
              patch_count=4)
    tk = MultiOutputConvKernel(RBF.create(1.3, 2.1, dtype=torch.float64), 4)
    Kuf = tk.Kuf(_t(Z), _t(PNL))
    assert tuple(Kuf.shape) == (4, 5, 6)
    _close(Kuf, jk.Kuf(jnp.asarray(Z), jnp.asarray(PNL)), 'Kuf')
    _close(tk.Kff(_t(PNL)), jk.Kff(jnp.asarray(PNL)), 'Kff')


@pytest.mark.parametrize('cross', [False, True], ids=['self', 'cross'])
def test_conv_kernel_K_blocked_is_bit_equal(cross):
    """``ConvKernel.K`` in blocks of 1, 2 and 3 images equals its one-block
    form bit for bit, and the JAX package's unblocked form to 1e-9."""
    rng = np.random.RandomState(3 + cross)
    view = FullView(input_size=(9, 8), filter_size=3, feature_maps=2,
                    stride=2)
    w = rng.rand(view.patch_count) + 0.5
    tk = ConvKernel.create(RBF.create(1.5, 2.0, dtype=torch.float64), view,
                           patch_weights=w, dtype=torch.float64)
    jk = JConvKernel.create(JRBF.create(1.5, 2.0, dtype=jnp.float64),
                            JFullView(input_size=(9, 8), filter_size=3,
                                      feature_maps=2, stride=2),
                            patch_weights=w, dtype=jnp.float64)
    X = rng.randn(7, 9 * 8 * 2)
    X2 = rng.randn(4, 9 * 8 * 2) if cross else None
    args = (_t(X),) if X2 is None else (_t(X), _t(X2))
    whole = tk.K(*args, block_rows=7)
    for b in (1, 2, 3):
        assert torch.equal(tk.K(*args, block_rows=b), whole), b
    assert torch.equal(tk.K(*args), whole)
    jargs = (jnp.asarray(X),) if X2 is None else (jnp.asarray(X),
                                                   jnp.asarray(X2))
    _close(whole, jk.K(*jargs), 'K')
    # MNIST's ConvKernel (P = 576) at N = 128 in float32: one image a
    # block, a [576, 73728] gram of 170 MB; float64 and N = 64 alike.
    assert gram_block_rows(576, 128, 4) == 1
    assert gram_block_rows(576, 64, 4) == 3
    assert gram_block_rows(576, 1, 4, limit=1 << 30) == 809


FLAGS = BuilderFlags(M='6,8', feature_maps='2', filter_sizes='5,3',
                     strides='2,1', num_samples=2, batch_size=4)
RBF_FLAGS = BuilderFlags(M='6,8', feature_maps='2', filter_sizes='5,3',
                         strides='2,1', last_kernel='rbf', num_samples=2,
                         batch_size=4)
IMAGE = (12, 12, 1)


@functools.lru_cache(maxsize=None)
def _models(last_kernel):
    flags = FLAGS if last_kernel == 'conv' else RBF_FLAGS
    rng = np.random.RandomState(11)
    X = rng.randn(32, *IMAGE)
    Y = rng.randint(0, 10, size=(32, 1))
    model = jbuild(flags, X, Y, jax.random.PRNGKey(0), dtype=np.float64)
    layers = []
    for layer in model.layers:
        M, R = layer.q_mu.shape
        q_sqrt = 0.3 * np.eye(M) + 0.05 * np.tril(rng.randn(R, M, M), -1)
        layers.append(layer.replace(q_mu=jnp.asarray(0.5 * rng.randn(M, R)),
                                    q_sqrt=jnp.asarray(q_sqrt)))
    model = model.replace(layers=tuple(layers))
    return model, port_of(model, flags, IMAGE), X.reshape(32, -1)


@pytest.mark.parametrize('which', ['conv_layer', 'svgp_conv', 'svgp_rbf'])
def test_layer_full_cov_and_sampling_match_jax(which):
    """``conditional_mean_var(full_cov=True)`` ([N, N, O]) and
    ``sample_from_conditional`` both ways, the port fed JAX's own draws
    (``mc_normal`` of the key: [O, N] full, [N, O] diagonal)."""
    model, port, X = _models('rbf' if which == 'svgp_rbf' else 'conv')
    i = 0 if which == 'conv_layer' else 1
    jl, tl = model.layers[i], port.layers[i]
    N = 4
    # The last layer reads the hidden layer's 4x4x2 output.
    ND = X[:N] if i == 0 else np.random.RandomState(7).randn(N, 32)
    mj, vj = jl.conditional_mean_var(jl.precompute(), jnp.asarray(ND),
                                     full_cov=True)
    m, v = tl.conditional_mean_var(tl.precompute(), _t(ND), full_cov=True)
    assert tuple(v.shape) == (N, N, tl.num_outputs)
    _close(m, mj, 'mean')
    _close(v, vj, 'var')
    key = jax.random.PRNGKey(9)
    for full_cov in (True, False):
        sj, msj, _ = jl.sample_from_conditional(jnp.asarray(ND), key,
                                                full_cov=full_cov)
        shape = (tl.num_outputs, N) if full_cov else (N, tl.num_outputs)
        z = np.asarray(jdgp.mc_normal(key, shape, jnp.float64))
        s, ms, _ = tl.sample_from_conditional(_t(ND), full_cov, noise=z)
        _close(ms, msj, f'sample mean full_cov={full_cov}')
        _close(s, sj, f'sample full_cov={full_cov}')
    with pytest.raises(ValueError, match='exactly one'):
        tl.sample_from_conditional(_t(ND), True)
    g = torch.Generator().manual_seed(0)
    s, _, _ = tl.sample_from_conditional(_t(ND), True, generator=g)
    assert torch.isfinite(s).all()


def test_full_cov_sample_finite_on_ill_conditioned_float32():
    """tests/test_numerics_core.py's near-duplicate inducing rows in
    float32: the floored covariance keeps the sampling Cholesky finite."""
    from deepcgp_tpu_torch.models.layers import SVGPLayer, fresh_q_sqrt
    from deepcgp_tpu_torch.models.mean_functions import Zero
    from deepcgp_tpu_torch.ops.linalg import add_jitter
    rng = np.random.RandomState(0)
    Z = rng.randn(8, 6) * 0.01
    Z[1], Z[3] = Z[0] + 1e-7, Z[2] + 1e-7
    k = RBF.create(1.0, 1.0)
    Zt = torch.as_tensor(Z, dtype=torch.float32)
    layer = SVGPLayer(k, Zt, torch.zeros(8, 3),
                      fresh_q_sqrt(add_jitter(k.K(Zt)), 3), Zero(3),
                      num_outputs=3)
    X = torch.as_tensor(rng.randn(4, 6) * 0.01, dtype=torch.float32)
    s, _, v = layer.sample_from_conditional(
        X, True, generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(s).all() and torch.isfinite(v).all()


@pytest.mark.parametrize('P', [48, 100])
def test_upper_base_case_padded_matches_unpadded_and_jax(P):
    """The card's route for a block that is not a multiple of 32 (§C5):
    the block padded with an identity tail, K2 and K3 (their plain versions
    here) on the padded block, the corner sliced.  Held against the
    unpadded plain version and the JAX upper base case (Pallas in
    interpret mode), float64 to 1e-10 of max |.|."""
    rng = np.random.RandomState(P)
    S = _spd(rng, 2, P) + np.eye(P)
    R, Ri = cuda_linalg.chol_inv_base_upper_padded(_t(S))
    R0, Ri0 = cuda_linalg.chol_inv_base_upper(_t(S))
    Rj, Rij = jax.jit(functools.partial(pallas_linalg.chol_inv_base_upper,
                                        interpret=True))(jnp.asarray(S))
    for a, b in ((R, R0), (Ri, Ri0), (R, Rj), (Ri, Rij)):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                                   atol=1e-10 * np.abs(b).max())
    assert (np.tril(R.numpy(), -1) == 0).all()
    np.testing.assert_allclose(R.numpy() @ np.swapaxes(R.numpy(), 1, 2), S,
                               rtol=0, atol=1e-11 * np.abs(S).max())
    assert cuda_linalg.chol_inv_base_upper.launches == 0
