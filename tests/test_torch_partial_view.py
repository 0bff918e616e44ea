"""The port's partial views against the JAX package on the CPU:
``RandomPartialView``'s positions for several seeds and sizes (and its
ValueError), its extraction and the extraction's gradient,
``PatchwiseConv2d``, and tests/test_trajectory_parity.py's partial-view
model -- a ``RandomPartialView`` hidden layer with the patchwise mean under
a ConvKernel last layer, carried over by ``convert.load_jax_leaves`` --
its ELBO and every gradient (rtol 1e-9) and 5 Adam steps (the trajectory
rule of tests/test_trajectory_parity.py), float64 with JAX's Monte-Carlo
draws replayed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models.base_kernels import RBF as JRBF
from deepcgp_tpu.models.conv_kernels import ConvKernel as JConvKernel
from deepcgp_tpu.models.dgp import DGP as JDGP
from deepcgp_tpu.models.layers import ConvLayer as JConvLayer
from deepcgp_tpu.models.layers import SVGPLayer as JSVGPLayer
from deepcgp_tpu.models.likelihoods import MultiClass as JMultiClass
from deepcgp_tpu.models.mean_functions import (PatchwiseConv2d as JPatchwise,
                                               Zero as JZero)
from deepcgp_tpu.models.views import (FullView as JFullView,
                                      RandomPartialView as JPartial)
from deepcgp_tpu.training import trainer as jtrainer

from deepcgp_tpu_torch.convert import load_jax_leaves
from deepcgp_tpu_torch.models.base_kernels import RBF
from deepcgp_tpu_torch.models.conv_kernels import ConvKernel
from deepcgp_tpu_torch.models.dgp import DGP
from deepcgp_tpu_torch.models.layers import ConvLayer, SVGPLayer
from deepcgp_tpu_torch.models.likelihoods import MultiClass
from deepcgp_tpu_torch.models.mean_functions import PatchwiseConv2d, Zero
from deepcgp_tpu_torch.models.views import FullView, RandomPartialView
from deepcgp_tpu_torch.training import trainer

from test_torch_training import jax_draws, jax_leaf

RTOL = 1e-9


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(a, b, what='', floor=0.0):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=RTOL,
                               atol=max(RTOL * np.abs(b).max(), floor),
                               err_msg=what)


def jax_leaves(model) -> dict:
    """What ``convert.load_jax_leaves`` takes: every leaf by key path."""
    return {''.join(str(k) for k in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(model)[0]}


@pytest.mark.parametrize('size,f,count,seed', [
    ((12, 12), 5, 9, 11), ((12, 12), 5, 49, 0), ((28, 28), 5, 144, 0),
    ((28, 28), 5, 144, 3), ((10, 14), 3, 30, 7), ((6, 6), 2, 16, 1)])
def test_partial_view_positions_match_jax(size, f, count, seed):
    jv = JPartial(input_size=size, filter_size=f, feature_maps=1,
                  patch_count=count, seed=seed)
    tv = RandomPartialView(input_size=size, filter_size=f, feature_maps=1,
                           patch_count=count, seed=seed)
    assert tv.patch_indices == jv.patch_indices
    assert (tv.out_image_height, tv.out_image_width, tv.patch_length) == \
        (jv.out_image_height, jv.out_image_width, jv.patch_length)


def test_partial_view_refuses_too_many_positions():
    """A 6x6 image with filter 2 has 4 x 4 sampleable starts."""
    for cls in (JPartial, RandomPartialView):
        with pytest.raises(ValueError, match='exceeds the 16 distinct'):
            cls(input_size=(6, 6), filter_size=2, feature_maps=1,
                patch_count=17)


def test_partial_view_extraction_and_patchwise_mean_match_jax():
    """Extraction [N, P, L] and its gradient (a random cotangent through
    both), and the patchwise mean on the extracted patches, 2 channels."""
    rng = np.random.RandomState(0)
    X = rng.randn(3, 11, 10, 2)
    G = rng.randn(3, 20, 18)
    jv = JPartial(input_size=(11, 10), filter_size=3, feature_maps=2,
                  patch_count=20, seed=4)
    tv = RandomPartialView(input_size=(11, 10), filter_size=3, feature_maps=2,
                           patch_count=20, seed=4)
    pj, vjp = jax.vjp(jv.extract_patches_NPL, jnp.asarray(X))
    Xt = _t(X).requires_grad_(True)
    pt = tv.extract_patches_NPL(Xt)
    np.testing.assert_array_equal(pt.detach().numpy(), np.asarray(pj))
    (gX,) = torch.autograd.grad(pt, Xt, _t(G))
    _close(gX.numpy(), vjp(jnp.asarray(G))[0], 'd images')
    mj, mt = (JPatchwise.create(3, 2, dtype=jnp.float64),
              PatchwiseConv2d.create(3, 2, dtype=torch.float64))
    np.testing.assert_array_equal(mt.conv_filter.numpy(),
                                  np.asarray(mj.conv_filter))
    _close(mt(pt.detach()).numpy(), mj(pj), 'patchwise mean')
    assert 'conv_filter' in dict(mt.named_buffers())
    assert not list(mt.parameters())


N = 96
IMAGE = (12, 12, 1)


@functools.lru_cache(maxsize=None)
def _jax_model():
    """tests/test_trajectory_parity.py's partial-view model, with q_mu moved
    off its symmetric zero start."""
    rng = np.random.RandomState(7)
    X = rng.randn(N, *IMAGE)
    Y = rng.randint(0, 10, size=(N, 1))
    view1 = JPartial(input_size=(12, 12), filter_size=5, feature_maps=1,
                     patch_count=9, seed=11)
    layer1 = JConvLayer.create(
        JRBF.create(5.0, 5.0, dtype=jnp.float64), view1,
        jnp.asarray(rng.randn(6, 25)),
        mean_function=JPatchwise.create(5, 1, dtype=jnp.float64),
        gp_count=1, q_sqrt_scale=1e-5, dtype=jnp.float64)
    view2 = JFullView(input_size=(3, 3), filter_size=3, feature_maps=1,
                      stride=1)
    layer2 = JSVGPLayer.create(
        JConvKernel.create(JRBF.create(5.0, 5.0, dtype=jnp.float64), view2,
                           dtype=jnp.float64),
        jnp.asarray(rng.randn(8, 9)), num_outputs=10,
        mean_function=JZero(output_dim=10), dtype=jnp.float64)
    model = JDGP(layers=(layer1, layer2), likelihood=JMultiClass(10),
                 num_data=N, num_samples=3)
    prng = np.random.RandomState(100)
    model = model.replace(layers=tuple(
        layer.replace(q_mu=layer.q_mu + 0.05 * jnp.asarray(
            prng.randn(*layer.q_mu.shape))) for layer in model.layers))
    return model, X.reshape(N, -1), Y


def port_partial_model(jmodel):
    """The same structure built by hand, every leaf loaded from JAX."""
    f64 = dict(dtype=torch.float64)
    view1 = RandomPartialView(input_size=(12, 12), filter_size=5,
                              feature_maps=1, patch_count=9, seed=11)
    layer1 = ConvLayer(RBF.create(**f64), torch.zeros(6, 25, **f64),
                       torch.zeros(6, 1, **f64),
                       torch.eye(6, **f64).expand(1, 6, 6).clone(),
                       PatchwiseConv2d.create(5, 1, **f64), view1)
    view2 = FullView(input_size=(3, 3), filter_size=3, feature_maps=1)
    layer2 = SVGPLayer(ConvKernel.create(RBF.create(**f64), view2, **f64),
                       torch.zeros(8, 9, **f64), torch.zeros(8, 10, **f64),
                       torch.eye(8, **f64).expand(10, 8, 8).clone(),
                       Zero(10), num_outputs=10)
    model = DGP([layer1, layer2], MultiClass(10), num_data=jmodel.num_data,
                num_samples=jmodel.num_samples)
    return load_jax_leaves(model, jax_leaves(jmodel))


def test_partial_view_model_elbo_and_gradients_match_jax():
    jmodel, X, Y = _jax_model()
    port = port_partial_model(jmodel)
    assert port.layers[0].view.patch_indices == \
        jmodel.layers[0].view.patch_indices
    key = jax.random.PRNGKey(3)
    xb, yb = X[:10], Y[:10]
    elbo_j, grads_j = jax.jit(jax.value_and_grad(
        lambda m, x, y: m.elbo(x, y, key)))(jmodel, jnp.asarray(xb),
                                             jnp.asarray(yb))
    params = dict(port.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    elbo = port.elbo(_t(xb), _t(yb), noise=jax_draws(jmodel, key, 10))
    grads = torch.autograd.grad(elbo, list(params.values()))
    np.testing.assert_allclose(float(elbo.detach()), float(elbo_j), rtol=RTOL)
    assert len(grads) == 11
    # The last layer's single patch weight (P = 1) has a gradient of
    # rounding size on both sides (3e-15 in JAX, against an ELBO of -853):
    # every leaf is also held to 1e-13 absolute.
    for name, g in zip(params, grads):
        _close(g.numpy(), jax_leaf(grads_j, name), name, floor=1e-13)


def test_partial_view_model_adam_trajectory_matches_jax():
    """5 Adam steps (lr 0.01, batch 8) on the same minibatches and draws,
    held to tests/test_trajectory_parity.py's rule (as
    tests/test_torch_training.py's trajectories): the ELBO and every
    parameter after every step at rtol 1e-6, with an absolute floor of
    1e-7 of the array's largest magnitude, since Adam's sqrt(v) + eps
    normalisation amplifies float64-level gradient differences on
    near-zero elements."""
    jmodel, X, Y = _jax_model()
    config = jtrainer.TrainConfig(optimizer='Adam', lr=0.01, batch_size=8)
    state_j = jtrainer.init_state(jmodel, config, jax.random.PRNGKey(1))
    step_j = jax.jit(lambda s, x, y: jtrainer.train_step(s, config, x, y))
    port = port_partial_model(jmodel)
    tconfig = trainer.TrainConfig(optimizer='Adam', lr=0.01, batch_size=8)
    state = trainer.init_state(port, tconfig)
    key = state_j.key
    brng = np.random.RandomState(2)
    for t in range(5):
        idx = brng.randint(0, N, size=8)
        key, k_mc = jax.random.split(key)
        noise = jax_draws(state_j.model, k_mc, 8)
        state_j, elbo_j = step_j(state_j, jnp.asarray(X[idx]),
                                 jnp.asarray(Y[idx]))
        elbo = trainer.train_step(state, tconfig, _t(X[idx]), _t(Y[idx]),
                                  noise=noise)
        np.testing.assert_allclose(float(elbo), float(elbo_j), rtol=1e-6,
                                   err_msg=f'step {t}')
        for name, p in state.params.items():
            ref = np.asarray(jax_leaf(state_j.model, name))
            if name.endswith('q_sqrt'):
                ref, p = np.tril(ref), torch.tril(p)
            np.testing.assert_allclose(
                p.detach().numpy(), ref, rtol=1e-6,
                atol=1e-7 * np.abs(ref).max() + 1e-12,
                err_msg=f'step {t} {name}')
    assert int(state.step) == 5
