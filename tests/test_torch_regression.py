"""The port's Gaussian likelihood and regression DGP against the JAX
package on the CPU, float64: ``Gaussian``'s variance, variational
expectations (and their gradients) and predictive moments; the
examples/regression.py DGP (two plain SVGP layers, the Gaussian variance
a trained leaf) carried over by ``convert.load_jax_leaves`` -- its ELBO,
``compute_log_likelihood`` and every gradient with JAX's draws replayed
(rtol 1e-9), and 5 Adam steps under the trajectory rule of
tests/test_trajectory_parity.py; and the port's example run end to end."""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models.likelihoods import Gaussian as JGaussian
from deepcgp_tpu.training import trainer as jtrainer

from deepcgp_tpu_torch.convert import load_jax_leaves
from deepcgp_tpu_torch.examples import regression
from deepcgp_tpu_torch.models.likelihoods import Gaussian
from deepcgp_tpu_torch.training import trainer

from test_torch_partial_view import jax_leaves
from test_torch_training import jax_draws

RTOL = 1e-9
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        'jax_regression_example', ROOT / 'examples' / 'regression.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gaussian_matches_jax():
    rng = np.random.RandomState(0)
    Fmu, Fvar, Y = rng.randn(3, 5, 2), rng.rand(3, 5, 2) + 0.1, rng.randn(3, 5, 2)
    jl = JGaussian.create(0.37, dtype=jnp.float64)
    tl = Gaussian.create(0.37, dtype=torch.float64)
    np.testing.assert_array_equal(tl.raw_variance.numpy(),
                                  np.asarray(jl.raw_variance))
    np.testing.assert_allclose(float(tl.variance), float(jl.variance),
                               rtol=RTOL)

    def jve(lik, m, v):
        return jnp.sum(lik.variational_expectations(m, v, jnp.asarray(Y))
                       * jnp.arange(1.0, 16.0).reshape(3, 5, 1))
    (gj, gm, gv) = jax.grad(jve, argnums=(0, 1, 2))(jl, jnp.asarray(Fmu),
                                                     jnp.asarray(Fvar))
    tl.raw_variance.requires_grad_(True)
    m, v = _t(Fmu).requires_grad_(True), _t(Fvar).requires_grad_(True)
    ve = tl.variational_expectations(m, v, _t(Y))
    assert tuple(ve.shape) == (3, 5, 1)
    np.testing.assert_allclose(
        ve.detach().numpy(),
        np.asarray(jl.variational_expectations(jnp.asarray(Fmu),
                                               jnp.asarray(Fvar),
                                               jnp.asarray(Y))), rtol=RTOL)
    grads = torch.autograd.grad(
        (ve * torch.arange(1.0, 16.0, dtype=torch.float64).reshape(3, 5, 1))
        .sum(), [tl.raw_variance, m, v])
    for g, ref in zip(grads, (gj.raw_variance, gm, gv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=RTOL)
    with torch.no_grad():
        pm, pv = tl.predict_mean_and_var(_t(Fmu), _t(Fvar))
    pmj, pvj = jl.predict_mean_and_var(jnp.asarray(Fmu), jnp.asarray(Fvar))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(pmj))
    np.testing.assert_allclose(pv.numpy(), np.asarray(pvj), rtol=RTOL)
    assert not hasattr(tl, 'predict_density')
    assert [n for n, _ in tl.named_parameters()] == ['raw_variance']


@functools.lru_cache(maxsize=None)
def _models():
    X, Y = regression.step_data(0)
    X, Y = X.astype(np.float64), Y.astype(np.float64)
    jmodel = _jax_example().build_regression_dgp(X, dtype=jnp.float64)
    # The example builds Gaussian(0.1) in float32 whatever the layers'
    # dtype; the reference here is float64 throughout.
    jmodel = jmodel.replace(likelihood=JGaussian.create(0.1,
                                                         dtype=jnp.float64))
    # Off the symmetric q_mu = 0 start, as the trajectory tests do.
    prng = np.random.RandomState(100)
    jmodel = jmodel.replace(layers=tuple(
        layer.replace(q_mu=layer.q_mu + 0.05 * jnp.asarray(
            prng.randn(*layer.q_mu.shape))) for layer in jmodel.layers))
    return jmodel, X, Y


def _port(jmodel, X):
    port = regression.build_regression_dgp(_t(X))
    return load_jax_leaves(port, jax_leaves(jmodel))


def test_regression_dgp_elbo_and_gradients_match_jax():
    jmodel, X, Y = _models()
    port = _port(jmodel, X)
    assert port.num_data == jmodel.num_data == 256
    assert port.num_samples == jmodel.num_samples == 5
    key = jax.random.PRNGKey(5)
    xb, yb = X[::4], Y[::4]
    elbo_j, grads_j = jax.jit(jax.value_and_grad(
        lambda m, x, y: m.compute_log_likelihood(x, y, key)))(
            jmodel, jnp.asarray(xb), jnp.asarray(yb))
    params = dict(port.named_parameters())
    assert 'likelihood.raw_variance' in params and len(params) == 11
    for p in params.values():
        p.requires_grad_(True)
    noise = jax_draws(jmodel, key, len(xb))
    elbo = port.compute_log_likelihood(_t(xb), _t(yb), noise=noise)
    assert float(elbo.detach()) == float(port.elbo(_t(xb), _t(yb),
                                                   noise=noise).detach())
    np.testing.assert_allclose(float(elbo.detach()), float(elbo_j), rtol=RTOL)
    grads = torch.autograd.grad(elbo, list(params.values()))
    for name, g in zip(params, grads):
        node = grads_j
        for part in name.split('.'):
            node = node[int(part)] if part.isdigit() else getattr(node, part)
        ref = np.asarray(node)
        np.testing.assert_allclose(g.numpy(), ref, rtol=RTOL,
                                   atol=RTOL * np.abs(ref).max(),
                                   err_msg=name)


def test_regression_adam_trajectory_matches_jax():
    """5 Adam steps (lr 0.01, batch 64) on float targets, the likelihood's
    raw variance among the trained leaves, on the same minibatches and
    draws: ELBO and every parameter after every step at rtol 1e-6 with an
    absolute floor of 1e-7 of the array's largest magnitude."""
    jmodel, X, Y = _models()
    config = jtrainer.TrainConfig(optimizer='Adam', lr=0.01, batch_size=64)
    state_j = jtrainer.init_state(jmodel, config, jax.random.PRNGKey(1))
    step_j = jax.jit(lambda s, x, y: jtrainer.train_step(s, config, x, y))
    tconfig = trainer.TrainConfig(optimizer='Adam', lr=0.01, batch_size=64)
    state = trainer.init_state(_port(jmodel, X), tconfig)
    key, brng = state_j.key, np.random.RandomState(2)
    for t in range(5):
        idx = brng.randint(0, len(X), size=64)
        key, k_mc = jax.random.split(key)
        noise = jax_draws(state_j.model, k_mc, 64)
        state_j, elbo_j = step_j(state_j, jnp.asarray(X[idx]),
                                 jnp.asarray(Y[idx]))
        elbo = trainer.train_step(state, tconfig, _t(X[idx]), _t(Y[idx]),
                                  noise=noise)
        np.testing.assert_allclose(float(elbo), float(elbo_j), rtol=1e-6)
        for name, p in state.params.items():
            node = state_j.model
            for part in name.split('.'):
                node = node[int(part)] if part.isdigit() else getattr(node, part)
            ref, p = np.asarray(node), p.detach()
            if name.endswith('q_sqrt'):
                ref, p = np.tril(ref), torch.tril(p)
            np.testing.assert_allclose(
                p.numpy(), ref, rtol=1e-6,
                atol=1e-7 * np.abs(ref).max() + 1e-12,
                err_msg=f'step {t} {name}')
    assert state.params['likelihood.raw_variance'].item() != \
        float(jmodel.likelihood.raw_variance)


def test_regression_example_runs(capsys):
    """The port's example on the CPU, 5 chunks of 3 steps: its lines, and
    a finite RMSE."""
    rmse = regression.main(['--steps-per-chunk', '3'], device='cpu')
    out = capsys.readouterr().out.splitlines()
    assert [line.split(':')[0] for line in out[:5]] == \
        [f'step {3 * (i + 1)}' for i in range(5)]
    assert out[5].startswith('train RMSE ') and np.isfinite(rmse)
    with pytest.raises(RuntimeError, match='CUDA'):
        if not torch.cuda.is_available():
            regression.main(['--steps-per-chunk', '1'])
        else:
            raise RuntimeError('CUDA is available')
