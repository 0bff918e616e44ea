"""The port's ArcCosine base kernel and conv mean functions against the JAX
package on the CPU: ``ArcCosine.K`` and ``Kdiag`` of every order, scalar
and ARD, their gradients; ``Conv2dMean`` and ``IdentityConv2dMean``; and a
2-layer model with an ArcCosine hidden layer and the identity mean
(``--base-kernel acos --identity-mean``): its ELBO, every gradient and
``predict_y`` with JAX's Monte-Carlo draws replayed, its snapshot read
and written by either package, and its filter kept out of training.

Gradients through ArcCosine are held to the JAX package's own acos rule
(tests/test_trajectory_parity.py: rtol 1e-6, atol 1e-7 of the leaf's
largest magnitude): on a self-gram's diagonal cos(theta) sits at its clip,
where arccos' is ~2e7 in float64, so the analytically zero gradient there
leaves a residue of a few ulps times that derivative on either side."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models.base_kernels import ArcCosine as JArcCosine
from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.models.mean_functions import (Conv2dMean as JConv2dMean,
                                               IdentityConv2dMean as JIdentity)
from deepcgp_tpu.utils import checkpoint as jckpt

from deepcgp_tpu_torch.models.base_kernels import ArcCosine
from deepcgp_tpu_torch.models.mean_functions import (Conv2dMean,
                                                     IdentityConv2dMean)
from deepcgp_tpu_torch.serving import Predictor
from deepcgp_tpu_torch.training import trainer
from deepcgp_tpu_torch.utils import checkpoint

from test_torch_serving import jax_draws as jax_draws_S
from test_torch_training import jax_draws, jax_leaf, port_of

ACOS_RTOL, ACOS_FLOOR = 1e-6, 1e-7
IMAGE = (12, 12, 3)
FLAGS = BuilderFlags(M='8,8', feature_maps='2', filter_sizes='5,3',
                     strides='2,1', base_kernel='acos', identity_mean=True,
                     num_samples=3, batch_size=8)
RAW = ('raw_variance', 'raw_weight_variances', 'raw_bias_variance')


def assert_acos_close(a, b, what):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=ACOS_RTOL,
                               atol=ACOS_FLOOR * np.abs(b).max() + 1e-300,
                               err_msg=what)


def _kernels(order, ard, rng):
    wv = 0.5 + rng.rand(6) if ard else 0.8
    jk = JArcCosine.create(variance=1.3, weight_variances=wv,
                           bias_variance=0.6, order=order, dtype=jnp.float64)
    tk = ArcCosine(*(torch.tensor(np.asarray(getattr(jk, n))) for n in RAW),
                   order=order)
    return jk, tk


@pytest.mark.parametrize('order', [0, 1, 2])
@pytest.mark.parametrize('ard', [False, True], ids=['scalar', 'ard'])
@pytest.mark.parametrize('cross', [False, True], ids=['self', 'cross'])
def test_arccosine_matches_jax(order, ard, cross):
    """K (batched over a leading axis, as a hidden layer calls it), Kdiag
    and the gradients of sum(K * G) + sum(Kdiag * g) with respect to the
    raw hyperparameters and the inputs, float64."""
    rng = np.random.RandomState(10 * order + 2 * ard + cross)
    jk, tk = _kernels(order, ard, rng)
    X = rng.randn(3, 5, 6)
    X2 = rng.randn(1, 4, 6) if cross else None
    G = rng.randn(3, 5, 4 if cross else 5)
    g = rng.randn(3, 5)

    def jloss(k, X):
        K = k.K(X, None if X2 is None else jnp.asarray(X2))
        return jnp.sum(K * G) + jnp.sum(k.Kdiag(X) * g), K

    (_, Kj), (gkj, gXj) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(jk, jnp.asarray(X))
    params = [p.requires_grad_(True) for p in tk.parameters()]
    Xt = torch.tensor(X, requires_grad=True)
    K = tk.K(Xt, None if X2 is None else torch.tensor(X2))
    loss = (K * torch.tensor(G)).sum() + (tk.Kdiag(Xt) * torch.tensor(g)).sum()
    grads = torch.autograd.grad(loss, params + [Xt])
    K, Kj = K.detach().numpy(), np.asarray(Kj)
    if cross:
        np.testing.assert_allclose(K, Kj, rtol=1e-12)
    else:
        # The self-gram's diagonal is arccos at the clip, theta ~ sqrt(2
        # eps): one ulp of cos(theta) moves it by ~5e-9 of K on either side.
        off = ~np.eye(5, dtype=bool)
        np.testing.assert_allclose(K[:, off], Kj[:, off], rtol=1e-12)
        np.testing.assert_allclose(np.diagonal(K, axis1=1, axis2=2),
                                   np.diagonal(Kj, axis1=1, axis2=2),
                                   rtol=1e-8)
    np.testing.assert_allclose(tk.Kdiag(Xt).detach().numpy(),
                               np.asarray(jk.Kdiag(jnp.asarray(X))),
                               rtol=1e-12)
    for name, grad in zip(RAW, grads):
        assert_acos_close(grad.numpy(), getattr(gkj, name), name)
    assert_acos_close(grads[-1].numpy(), gXj, 'X')
    assert tuple(tk.raw_weight_variances.shape) == ((6,) if ard else ())


def test_arccosine_float32_clip_keeps_gradients_finite():
    """In float32 the squeeze before arccos is 1e-6 (gpflow's 1e-15 rounds
    away), so the self-gram's gradient stays finite."""
    tk = ArcCosine.create(order=0, dtype=torch.float32)
    for p in tk.parameters():
        p.requires_grad_(True)
    X = torch.randn(4, 7, dtype=torch.float32, requires_grad=True)
    grads = torch.autograd.grad(tk.K(X).sum(), [X, *tk.parameters()])
    assert all(torch.isfinite(g).all() for g in grads)
    with pytest.raises(ValueError, match='order'):
        ArcCosine.create(order=3)


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('identity', [False, True],
                         ids=['conv2d_mean', 'identity_conv2d_mean'])
def test_conv_means_match_jax(stride, identity):
    """Conv2dMean (the delta of channel 0 -> map 0, flattened NHWC) and
    IdentityConv2dMean (every channel pair, NHWC), fm_in 3: equal to the
    JAX package's, and the filter equal to its filter."""
    rng = np.random.RandomState(stride)
    X = rng.randn(4, 11, 13, 3)
    if identity:
        jm, tm = (JIdentity.create(5, 3, 4, stride=stride, dtype=jnp.float64),
                  IdentityConv2dMean.create(5, 3, 4, stride=stride,
                                            dtype=torch.float64))
    else:
        jm, tm = (JConv2dMean.create(5, 3, 4, stride=stride, dtype=jnp.float64),
                  Conv2dMean.create(5, 3, 4, stride=stride, dtype=torch.float64))
    np.testing.assert_array_equal(tm.conv_filter.numpy(),
                                  np.asarray(jm.conv_filter))
    out = tm(torch.tensor(X)).numpy()
    ref = np.asarray(jm(jnp.asarray(X)))
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    assert not list(tm.parameters())
    assert list(dict(tm.named_buffers())) == ['conv_filter']


@functools.lru_cache(maxsize=None)
def _jax_model():
    """The 2-layer acos + identity-mean model in float64, with
    trained-looking variational parameters and hyperparameters away from
    their defaults."""
    rng = np.random.RandomState(3)
    X = rng.randn(48, *IMAGE)
    Y = rng.randint(0, 10, size=(48, 1))
    model = jbuild(FLAGS, X, Y, jax.random.PRNGKey(0), dtype=np.float64)
    layers = []
    for layer in model.layers:
        M, R = layer.q_mu.shape
        q_sqrt = 0.3 * np.eye(M) + 0.05 * np.tril(rng.randn(R, M, M), -1)
        layer = layer.replace(q_mu=jnp.asarray(0.5 * rng.randn(M, R)),
                              q_sqrt=jnp.asarray(q_sqrt))
        if not hasattr(layer, 'kernel'):
            layer = layer.replace(base_kernel=JArcCosine.create(
                variance=1.4, weight_variances=0.7, bias_variance=0.5,
                dtype=jnp.float64))
        layers.append(layer)
    return model.replace(layers=tuple(layers)), X.reshape(48, -1), Y


def test_model_elbo_gradients_and_predict_y_match_jax():
    model, X, Y = _jax_model()
    Xb, Yb = X[:10], Y[:10]
    key = jax.random.PRNGKey(7)
    elbo_j, grads_j = jax.jit(jax.value_and_grad(
        lambda m, x, y: m.elbo(x, y, key)))(model, jnp.asarray(Xb),
                                             jnp.asarray(Yb))
    port = port_of(model, FLAGS, IMAGE)
    assert isinstance(port.layers[0].base_kernel, ArcCosine)
    assert isinstance(port.layers[0].mean_function, Conv2dMean)
    params = dict(port.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    elbo = port.elbo(torch.as_tensor(Xb), torch.as_tensor(Yb),
                     noise=jax_draws(model, key, 10))
    grads = dict(zip(params, torch.autograd.grad(elbo, list(params.values()))))
    np.testing.assert_allclose(float(elbo.detach()), float(elbo_j), rtol=1e-9)
    assert len(grads) == 12
    for name, g in grads.items():
        assert_acos_close(g.numpy(), jax_leaf(grads_j, name), name)
    S, pkey = 4, jax.random.PRNGKey(9)
    pj, vj = model.predict_y(jnp.asarray(Xb), pkey, S)
    p, v = port.predict_y(torch.as_tensor(Xb), S,
                          noise=jax_draws_S(model, pkey, 10, S))
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-9, atol=1e-15)
    # The identity mean moves the answer: the hidden layer's mean is not 0.
    assert float(port.layers[0].mean_function(
        torch.as_tensor(Xb).reshape(10, *IMAGE)).abs().max()) > 0.1


def _options(root, name, flags):
    """<root>/<name>/options.toml of ``flags``, beside <root>/<name>.npy, as
    a training run leaves them."""
    run = os.path.join(root, name)
    os.makedirs(run)
    with open(os.path.join(run, 'options.toml'), 'w') as f:
        f.write(f'name = "{name}"\n')
        for k in ('M', 'feature_maps', 'filter_sizes', 'strides',
                  'base_kernel', 'last_kernel'):
            f.write(f'{k} = "{getattr(flags, k)}"\n')
        f.write(f'white = false\nidentity_mean = '
                f'{str(flags.identity_mean).lower()}\nnum_samples = 3\n')
    return run


def test_snapshot_both_ways(tmp_path):
    """The JAX model's snapshot served by the port's Predictor from its run
    dir (the ArcCosine keys, the rebuilt delta filter), and the port's own
    snapshot read back by the JAX package: the same hyperparameters."""
    model, X, _ = _jax_model()
    root = str(tmp_path)
    jckpt.save_model(os.path.join(root, 'acos.npy'), model, 4)
    pred = Predictor.from_run_dir(_options(root, 'acos', FLAGS), IMAGE,
                                  batch_size=8, num_samples=3,
                                  dtype=torch.float64, device='cpu')
    base = pred.model.layers[0].base_kernel
    jbase = model.layers[0].base_kernel
    for n in ('variance', 'weight_variances', 'bias_variance'):
        np.testing.assert_allclose(getattr(base, n).numpy(),
                                   np.asarray(getattr(jbase, n)), rtol=1e-12)
    np.testing.assert_array_equal(
        pred.model.layers[0].mean_function.conv_filter.numpy(),
        np.asarray(model.layers[0].mean_function.conv_filter))
    key = jax.random.PRNGKey(3)
    pj, _ = model.predict_y(jnp.asarray(X[:6]), key, 3)
    p, _ = pred.model.predict_y(torch.as_tensor(X[:6]), 3,
                                noise=jax_draws_S(model, key, 6, 3))
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-9)

    saved = checkpoint.model_parameters(pred.model, 4)
    want = jckpt.model_parameters(model, 4)
    assert sorted(saved) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(saved[k], v, rtol=1e-12, err_msg=k)
    _, loaded = jckpt.parse_layer_parameters(saved, 2)
    back = jbuild(FLAGS, X.reshape(-1, *IMAGE), np.zeros((48, 1), int),
                  jax.random.PRNGKey(0), loaded_parameters=loaded,
                  dtype=np.float64)
    for n in ('variance', 'weight_variances', 'bias_variance'):
        np.testing.assert_allclose(
            np.asarray(getattr(back.layers[0].base_kernel, n)),
            np.asarray(getattr(jbase, n)), rtol=1e-12)


def test_filter_is_not_trained_and_the_model_serves(tmp_path):
    """``conv_filter`` is a buffer: in the state dict, outside the
    trainable set, unchanged by Adam steps.  The trained model's snapshot
    serves the same parameters through the Predictor."""
    model, X, Y = _jax_model()
    port = port_of(model, FLAGS, IMAGE)
    assert 'layers.0.mean_function.conv_filter' in port.state_dict()
    assert not any('conv_filter' in n for n, _ in port.named_parameters())
    filt = port.layers[0].mean_function.conv_filter.clone()
    config = trainer.TrainConfig(batch_size=8)
    state = trainer.init_state(port, config, seed=2)
    assert not any('conv_filter' in k for k in state.opt_state['mu'])
    trace = trainer.run_chunk(state, config, torch.as_tensor(X),
                              torch.as_tensor(Y), 3)
    assert torch.isfinite(trace).all()
    assert torch.equal(port.layers[0].mean_function.conv_filter, filt)
    root = str(tmp_path)
    checkpoint.save_model(os.path.join(root, 'trained.npy'), port, 3)
    pred = Predictor.from_run_dir(_options(root, 'trained', FLAGS), IMAGE,
                                  batch_size=8, num_samples=3,
                                  dtype=torch.float64, device='cpu')
    for (name, p), q in zip(port.named_parameters(), pred.model.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    probs = pred.predict_proba(X[:11])
    assert probs.shape == (11, 10) and np.isfinite(probs).all()
