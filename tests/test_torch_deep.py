"""Three-layer stacks of the port against the JAX package on the CPU, at
``tests/test_deep_stack.py``'s geometry (16x16x1 -f5/s2-> 6x6x2 -f3/s1->
4x4x2 -> ConvKernel over a 2x2 patch grid): the second hidden layer reads
the [S*N] per-sample rows of the first, and its patch extraction is
differentiated with respect to a sample.  The ELBO, every gradient and
``predict_y`` with the identity mean over an RBF and over an ArcCosine
base (JAX's Monte-Carlo draws replayed), 5-step Adam and NatGrad
trajectories, a JAX snapshot served by the port, a 2-layer snapshot
loaded into the 3-layer model, and the extraction's backward: the same on two runs and equal to autograd's
through the strided view."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models.base_kernels import ArcCosine as JArcCosine
from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.training import trainer as jtrainer
from deepcgp_tpu.utils import checkpoint as jckpt

from deepcgp_tpu_torch.models.builder import build_model
from deepcgp_tpu_torch.ops import patches
from deepcgp_tpu_torch.training import trainer
from deepcgp_tpu_torch.utils import checkpoint

from test_torch_acos import assert_acos_close
from test_torch_serving import jax_draws as jax_draws_S
from test_torch_training import jax_draws, jax_leaf, port_of

IMAGE = (16, 16, 1)
DEEP = dict(M='8,8,8', feature_maps='2,2', filter_sizes='5,3,3',
            strides='2,1,1', identity_mean=True, num_samples=2, batch_size=8)
FLAGS = {'rbf': BuilderFlags(**DEEP),
         'acos': BuilderFlags(**DEEP, base_kernel='acos')}
NUM_IMAGES = 64


def _data(seed):
    """Class prototypes plus noise, as tests/test_deep_stack.py draws them."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(4, *IMAGE)
    Y = rng.randint(0, 4, size=(NUM_IMAGES, 1))
    X = protos[Y[:, 0]] + 0.3 * rng.randn(NUM_IMAGES, *IMAGE)
    return X, Y, rng


@functools.lru_cache(maxsize=None)
def _jax_model(kind):
    """The 3-layer JAX model in float64, with trained-looking variational
    parameters (and, for acos, hyperparameters away from the defaults)."""
    X, Y, rng = _data(0)
    model = jbuild(FLAGS[kind], X, Y, jax.random.PRNGKey(0), dtype=np.float64)
    assert len(model.layers) == 3
    assert model.layers[1].view.patch_count == 16
    layers = []
    for i, layer in enumerate(model.layers):
        M, R = layer.q_mu.shape
        q_sqrt = 0.3 * np.eye(M) + 0.05 * np.tril(rng.randn(R, M, M), -1)
        layer = layer.replace(q_mu=jnp.asarray(0.5 * rng.randn(M, R)),
                              q_sqrt=jnp.asarray(q_sqrt))
        if kind == 'acos' and not hasattr(layer, 'kernel'):
            layer = layer.replace(base_kernel=JArcCosine.create(
                variance=1.2 + 0.2 * i, weight_variances=0.7,
                bias_variance=0.5, dtype=jnp.float64))
        layers.append(layer)
    return model.replace(layers=tuple(layers)), X.reshape(NUM_IMAGES, -1), Y


@pytest.mark.parametrize('kind', ['rbf', 'acos'])
def test_elbo_gradients_and_predict_y_match_jax(kind):
    """float64: the ELBO and ``predict_y`` within 1e-9 relative; each
    gradient within 1e-9 of its leaf's largest magnitude (RBF), or the
    JAX package's acos rule (``assert_acos_close``)."""
    model, X, Y = _jax_model(kind)
    Xb, Yb = X[:10], Y[:10]
    key = jax.random.PRNGKey(7)
    elbo_j, grads_j = jax.jit(jax.value_and_grad(
        lambda m, x, y: m.elbo(x, y, key)))(model, jnp.asarray(Xb),
                                             jnp.asarray(Yb))
    port = port_of(model, FLAGS[kind], IMAGE)
    params = dict(port.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    elbo = port.elbo(torch.as_tensor(Xb), torch.as_tensor(Yb),
                     noise=jax_draws(model, key, 10))
    grads = dict(zip(params, torch.autograd.grad(elbo, list(params.values()))))
    np.testing.assert_allclose(float(elbo.detach()), float(elbo_j), rtol=1e-9)
    assert len(grads) == (18 if kind == 'acos' else 16)
    for name, g in grads.items():
        ref = np.asarray(jax_leaf(grads_j, name))
        if kind == 'acos':
            assert_acos_close(g.numpy(), ref, name)
        else:
            np.testing.assert_allclose(g.numpy(), ref, rtol=1e-9,
                                       atol=1e-9 * np.abs(ref).max(),
                                       err_msg=name)
    # The second hidden layer's Z is reached through the per-sample rows.
    assert float(grads['layers.1.Z'].abs().max()) > 0
    S, pkey = 3, jax.random.PRNGKey(9)
    pj, vj = model.predict_y(jnp.asarray(Xb), pkey, S)
    p, v = port.predict_y(torch.as_tensor(Xb), S,
                          noise=jax_draws_S(model, pkey, 10, S))
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize('optimizer', ['Adam', 'NatGrad'])
def test_trajectory_matches_jax(optimizer):
    """5 steps of the 3-layer RBF + identity-mean model against the JAX
    package's ``train_step`` in float64: the ELBO and every parameter at
    rtol 1e-6, with an absolute floor of 1e-7 of the array's largest
    magnitude (tests/test_trajectory_parity.py's rule).  NatGrad stacks the
    three layers' (M, R) = (8, 2), (8, 2), (8, 10) GPs into one update of
    14 and NatGrad's backoff stays at 0."""
    model, X, Y = _jax_model('rbf')
    config = jtrainer.TrainConfig(optimizer=optimizer, lr=0.01, batch_size=8,
                                  gamma=0.01)
    state_j = jtrainer.init_state(model, config, jax.random.PRNGKey(1))
    step_j = jax.jit(lambda s, x, y: jtrainer.train_step(s, config, x, y))
    tconfig = trainer.TrainConfig(optimizer=optimizer, lr=0.01, batch_size=8,
                                  gamma=0.01)
    state = trainer.init_state(port_of(model, FLAGS['rbf'], IMAGE), tconfig)
    key = state_j.key
    brng = np.random.RandomState(2)
    for t in range(5):
        idx = brng.randint(0, NUM_IMAGES, size=8)
        key, k_mc = jax.random.split(key)
        noise = jax_draws(state_j.model, k_mc, 8)
        state_j, elbo_j = step_j(state_j, jnp.asarray(X[idx]),
                                 jnp.asarray(Y[idx]))
        elbo = trainer.train_step(state, tconfig, torch.as_tensor(X[idx]),
                                  torch.as_tensor(Y[idx]), noise=noise)
        np.testing.assert_allclose(float(elbo), float(elbo_j), rtol=1e-6,
                                   err_msg=f'step {t}')
        for name, p in state.params.items():
            ref = np.asarray(jax_leaf(state_j.model, name))
            p = p.detach()
            if name.endswith('q_sqrt'):
                ref, p = np.tril(ref), torch.tril(p)
            np.testing.assert_allclose(p.numpy(), ref, rtol=1e-6,
                                       atol=1e-7 * np.abs(ref).max() + 1e-12,
                                       err_msg=f'step {t} {name}')
    assert int(state.step) == 5
    if optimizer == 'NatGrad':
        assert float(state.steps_back) == float(state_j.steps_back) == 0.0
        # The natural gradient takes every q_mu and q_sqrt, Adam the rest of
        # the parameters; no buffer (Z0, the mean's filter) is in either.
        natural = {k for k in state.params if k.endswith(('q_mu', 'q_sqrt'))}
        assert len(natural) == 6
        assert set(state.opt_state['mu']) | natural == set(state.params)
        assert not set(state.opt_state['mu']) & natural
        assert not set(state.params) & set(dict(state.model.named_buffers()))


def test_jax_snapshot_serves_through_port(tmp_path):
    """The 3-layer acos + identity-mean JAX model's snapshot, served by the
    port's ``Predictor.from_run_dir`` from its run dir's options.toml:
    the JAX model's ``predict_y`` on the same draws."""
    from test_torch_acos import _options
    from deepcgp_tpu_torch.serving import Predictor
    model, X, _ = _jax_model('acos')
    root = str(tmp_path)
    jckpt.save_model(os.path.join(root, 'deep.npy'), model, 5)
    pred = Predictor.from_run_dir(_options(root, 'deep', FLAGS['acos']),
                                  IMAGE, batch_size=8, num_samples=2,
                                  dtype=torch.float64, device='cpu')
    assert len(pred.model.layers) == 3
    key = jax.random.PRNGKey(4)
    pj, _ = model.predict_y(jnp.asarray(X[:6]), key, 2)
    p, _ = pred.model.predict_y(torch.as_tensor(X[:6]), 2,
                                noise=jax_draws_S(model, key, 6, 2))
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-9,
                               atol=1e-15)
    assert np.isfinite(pred.predict_proba(X[:9])).all()


def test_two_layer_snapshot_loads_into_three_layers(tmp_path):
    """The depth remap: a 2-layer snapshot's last layer moves into the
    3-layer model's last slot, its first layer stays first, and the new
    middle layer initialises fresh from the images -- in the port as in
    the JAX package, which parse the snapshot to the same dicts."""
    X, Y, _ = _data(1)
    shallow = BuilderFlags(M='8,8', feature_maps='2', filter_sizes='5,3',
                           strides='2,1', identity_mean=True, num_samples=2)
    small = build_model(shallow, IMAGE, images=X, dtype=torch.float64,
                        device='cpu')
    path = os.path.join(str(tmp_path), 'shallow.npy')
    checkpoint.save_model(path, small, 7)
    raw = checkpoint.load_raw(path)
    step, loaded = checkpoint.parse_layer_parameters(raw, 3)
    step_j, loaded_j = jckpt.parse_layer_parameters(jckpt.load_raw(path), 3)
    assert step == step_j == 7 and sorted(loaded) == sorted(loaded_j) == [0, 2]
    for i in loaded:
        assert sorted(loaded[i]) == sorted(loaded_j[i])
        for k, v in loaded[i].items():
            np.testing.assert_array_equal(v, loaded_j[i][k])
    deep = build_model(FLAGS['rbf'], IMAGE, loaded, images=X,
                       dtype=torch.float64, device='cpu')
    jdeep = jbuild(FLAGS['rbf'], X, Y, jax.random.PRNGKey(0),
                   loaded_parameters=loaded_j, dtype=np.float64)
    for i, j in ((0, 0), (2, 1)):
        for name in ('Z', 'q_mu', 'q_sqrt'):
            got = getattr(deep.layers[i], name).detach().numpy()
            np.testing.assert_array_equal(got, getattr(small.layers[j], name)
                                          .detach().numpy())
            np.testing.assert_allclose(got, np.asarray(
                getattr(jdeep.layers[i], name)), rtol=1e-12)
    fresh = deep.layers[1]
    assert fresh.Z.shape == (8, 18) and not fresh.q_mu.any()
    elbo = deep.elbo(torch.as_tensor(X[:8].reshape(8, -1)), torch.as_tensor(Y[:8]),
                     generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(elbo)
    with pytest.raises(ValueError, match='deeper'):
        checkpoint.parse_layer_parameters(raw, 1)


@pytest.mark.parametrize('geometry', [(40, 6, 6, 2, 3, 1, 1),
                                      (6, 16, 16, 1, 5, 2, 1),
                                      (5, 11, 13, 3, 3, 2, 2)])
def test_extraction_backward_is_col2im(geometry):
    """The hidden layers' extraction (``cuda_patches.tf_order_patches``)
    gives the strided copy's values, and its backward, K7 on the cotangent
    gathered into transposed order, gives the same bits on two runs and
    equals autograd's through the strided view."""
    from deepcgp_tpu_torch.ops import cuda_patches
    N, H, W, C, f, s, d = geometry
    rng = np.random.RandomState(N)
    X = torch.tensor(rng.randn(N, H, W, C), requires_grad=True)
    out = cuda_patches.tf_order_patches(X, f, s, d)
    assert torch.equal(out, patches.extract_patches(X, f, s, d))
    G = torch.tensor(rng.randn(*out.shape))
    runs = [torch.autograd.grad(cuda_patches.tf_order_patches(X, f, s, d), X,
                                G)[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    strided, = torch.autograd.grad(patches.extract_patches(X, f, s, d), X, G)
    np.testing.assert_allclose(runs[0].numpy(), strided.numpy(), rtol=1e-13,
                               atol=1e-13)
    Hout, Wout = patches.out_size(H, f, s, d), patches.out_size(W, f, s, d)
    perm = patches.transposed_patch_perm(Hout, Wout)
    k7 = cuda_patches.col2im_transposed_plain(G[:, perm], (H, W, C), f, s, d)
    assert torch.equal(runs[0], k7)
    assert cuda_patches.col2im_transposed.launches == 0
