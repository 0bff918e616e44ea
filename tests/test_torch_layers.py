"""Parity of the PyTorch port's models (deepcgp_tpu_torch/models) with the
JAX package on the CPU: the RBF base kernel and the robust-max likelihood,
then the whole serving slice -- a small 2-layer conv-GP built by the JAX
builder, carried over with ``from_jax_parameters`` and fed the JAX
package's own Monte-Carlo draws."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models import dgp as jdgp
from deepcgp_tpu.models.base_kernels import RBF as JRBF
from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.models.likelihoods import MultiClass as JMultiClass
from deepcgp_tpu.models.layers import ConvLayer as JConvLayer
from deepcgp_tpu.utils import checkpoint as jckpt

from deepcgp_tpu_torch.convert import from_jax_parameters
from deepcgp_tpu_torch.models.base_kernels import RBF
from deepcgp_tpu_torch.models.likelihoods import MultiClass
from deepcgp_tpu_torch.ops import cuda_cross, cuda_linalg

IMAGE = (12, 12, 3)
FLAGS = BuilderFlags(M='64,64', feature_maps='3', filter_sizes='3,3',
                     strides='2,1', num_samples=3, batch_size=8)
S = 3


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize('ard', [False, True])
@pytest.mark.parametrize('self_gram', [True, False])
def test_rbf_K(ard, self_gram):
    rng = np.random.RandomState(0)
    X = rng.randn(4, 6, 5)
    X2 = None if self_gram else rng.randn(1, 7, 5)
    jk = JRBF.create(1.7, 0.8, ard_dim=5 if ard else None, dtype=jnp.float64)
    tk = RBF(_t(jk.raw_variance), _t(jk.raw_lengthscales))
    ref = jk.K(jnp.asarray(X), None if X2 is None else jnp.asarray(X2))
    out = tk.K(_t(X), None if X2 is None else _t(X2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tk.Kdiag(_t(X)).numpy(),
                               np.asarray(jk.Kdiag(jnp.asarray(X))), rtol=1e-12)


def test_multiclass_predict():
    rng = np.random.RandomState(1)
    mu = rng.randn(2, 5, 10)
    var = rng.rand(2, 5, 10) * 2
    var[0, 0, 0] = 0.0          # the clip below 1e-10
    Y = rng.randint(0, 10, size=(2, 5, 1))
    jl, tl = JMultiClass(10), MultiClass(10)
    mj, vj = jl.predict_mean_and_var(jnp.asarray(mu), jnp.asarray(var))
    m, v = tl.predict_mean_and_var(_t(mu), _t(var))
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-10, atol=1e-13)
    dj = jl.predict_density(jnp.asarray(mu), jnp.asarray(var), jnp.asarray(Y))
    d = tl.predict_density(_t(mu), _t(var), _t(Y))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-10)


@functools.lru_cache(maxsize=None)
def _jax_model64():
    rng = np.random.RandomState(2)
    X = rng.randn(48, *IMAGE)
    Y = rng.randint(0, 10, size=(48, 1))
    model = jbuild(FLAGS, X, Y, jax.random.PRNGKey(0), dtype=np.float64)
    # A fresh model predicts 0.1 for every class (q_mu = 0): give it the
    # variational parameters and patch weights of a trained-looking one.
    layers = []
    for layer in model.layers:
        M, R = layer.q_mu.shape
        q_sqrt = 0.3 * np.eye(M) + 0.05 * np.tril(rng.randn(R, M, M), -1)
        layer = layer.replace(q_mu=jnp.asarray(0.5 * rng.randn(M, R)),
                              q_sqrt=jnp.asarray(q_sqrt))
        if hasattr(layer, 'kernel'):
            w = rng.rand(layer.kernel.patch_weights.shape[0]) + 0.5
            layer = layer.replace(kernel=layer.kernel.replace(
                patch_weights=jnp.asarray(w)))
        layers.append(layer)
    return model.replace(layers=tuple(layers)), X.reshape(48, -1), Y


def _jax_model(dtype):
    """The model in ``dtype``: the float32 one is the float64 one's
    parameters cast, so both dtypes share one build."""
    model, X, Y = _jax_model64()
    if dtype == np.float32:
        model = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, model)
    return model, X.astype(dtype), Y


def _port(model, device='cpu'):
    params = jckpt.model_parameters(model, 0)
    Z0 = [np.asarray(l.Z0) for l in model.layers if isinstance(l, JConvLayer)]
    return from_jax_parameters(FLAGS, IMAGE, params, Z0, device=device)


def jax_draws(model, key, N):
    """The standard normals ``dgp.propagate`` draws: one key split per
    layer, then ``mc_normal`` at the layer's [S, N, O] shape."""
    out = []
    for layer in model.layers:
        key, sub = jax.random.split(key)
        O = layer.num_outputs
        out.append(np.array(jdgp.mc_normal(sub, (S, N, O), layer.q_mu.dtype)))
    return out


def _compare(model, port, X, Y, tol, dtol):
    key = jax.random.PRNGKey(7)
    noise = jax_draws(model, key, X.shape[0])
    pj, vj = model.predict_y(jnp.asarray(X), key, S)
    p, v = port.predict_y(_t(X), S, noise=noise)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), **tol)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), **tol)
    dj = model.predict_density(jnp.asarray(X), jnp.asarray(Y), key, S)
    d = port.predict_density(_t(X), _t(Y), S, noise=noise)
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), **dtol)
    return p


def test_slice_f64_matches_jax():
    model, X, Y = _jax_model(np.float64)
    port = _port(model)
    tol = dict(rtol=1e-9, atol=1e-12)
    p = _compare(model, port, X[:10], Y[:10], tol, tol)
    assert p.dtype == torch.float64 and p.shape == (S, 10, 10)
    # Informative: not every class at the same probability.
    assert float(p.std()) > 1e-3


def test_slice_f32_through_kernel_paths_matches_jax(monkeypatch):
    """float32 with the JAX package forced through its Pallas kernels
    (interpret mode): K1's driver and K4 on both sides.  Tolerance 1e-4
    absolute on probabilities in [0, 1] (the bound chip_smoke.py holds the
    card to) and 1e-4 relative on log-densities near -2: float32 rounding
    in other orders, amplified by the k-means Kuu's conditioning through
    two GP layers (4e-5 and 5e-5 measured here)."""
    monkeypatch.setenv('DEEPCGP_PALLAS_FORCE', '1')
    monkeypatch.setenv('DEEPCGP_PALLAS_CROSS', '1')
    model, X, Y = _jax_model(np.float32)
    port = _port(model)
    assert cuda_cross.supported(port.layers[-1].kernel)
    calls = {'k1': 0, 'k3': 0, 'k4': 0}
    cross = cuda_cross.conv_rbf_cross_plain

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(cuda_linalg, 'chol_factor_blocked_plain',
                        count('k1', cuda_linalg.chol_factor_blocked_plain))
    monkeypatch.setattr(cuda_linalg, 'tri_inv_blocked_plain',
                        count('k3', cuda_linalg.tri_inv_blocked_plain))
    monkeypatch.setattr(cuda_cross, 'conv_rbf_cross_plain', count('k4', cross))
    p = _compare(model, port, X[:10], Y[:10], dict(rtol=0, atol=1e-4),
                 dict(rtol=1e-4))
    assert p.dtype == torch.float32
    # Both predict_y and predict_density went through the kernel paths:
    # one K1 and one K3 call for the batched Kuu, and one cross per call.
    assert calls == {'k1': 2, 'k3': 2, 'k4': 2}
