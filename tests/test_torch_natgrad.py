"""The PyTorch port's NatGrad training and its plain-RBF last layer against
the JAX package on the CPU: a NatGrad trajectory against
``trainer.train_step`` in float64, one float32 NatGrad step through the
kernel paths (the JAX package's Pallas kernels in interpret mode, the
port's plain versions), the commit guard and the deferred-verification
rollback, the terminal verification of ``run_chunk``, the ARD-RBF last
layer (ELBO, gradients, builder, convert and snapshot round trips) and
k-means++.  Both sides get the same parameters, minibatches and
Monte-Carlo noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models import dgp as jdgp
from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.models.layers import ConvLayer as JConvLayer
from deepcgp_tpu.ops import kmeans as jkmeans
from deepcgp_tpu.training import trainer as jtrainer
from deepcgp_tpu.utils import checkpoint as jckpt

from deepcgp_tpu_torch.convert import from_jax_parameters
from deepcgp_tpu_torch.models.builder import build_model
from deepcgp_tpu_torch.ops import cuda_cross, cuda_linalg
from deepcgp_tpu_torch.ops.kmeans import _plusplus_init, kmeans
from deepcgp_tpu_torch.training import optim, trainer
from deepcgp_tpu_torch.utils import checkpoint

SMALL_IMAGE = (12, 12, 1)
RBF_IMAGE = (6, 6, 1)
RBF_FLAGS = BuilderFlags(M='16', feature_maps='', filter_sizes='5', strides='1',
                         last_kernel='rbf', num_samples=3, batch_size=8)


def small_flags(**kw):
    return BuilderFlags(**{**dict(M='6,8', feature_maps='2', filter_sizes='5,3',
                                  strides='2,1', num_samples=3, batch_size=8), **kw})


def jax_draws(model, key, N):
    """The standard normals ``dgp.propagate`` draws for N rows and the
    model's num_samples: one key split per layer, then ``mc_normal``."""
    out = []
    for layer in model.layers:
        key, sub = jax.random.split(key)
        out.append(np.array(jdgp.mc_normal(
            sub, (model.num_samples, N, layer.num_outputs), layer.q_mu.dtype)))
    return out


def port_of(model, flags, image):
    params = jckpt.model_parameters(model, 0)
    Z0 = [np.asarray(l.Z0) for l in model.layers if isinstance(l, JConvLayer)]
    return from_jax_parameters(flags, image, params, Z0,
                               num_data=model.num_data, device='cpu')


def jax_leaf(model, name):
    """The JAX model's leaf for a port parameter name."""
    _, i, *path = name.split('.')
    node = model.layers[int(i)]
    for part in path:
        node = getattr(node, part)
    return node


def _assert_params_close(params, jmodel, rtol, floor, what):
    for name, p in params.items():
        ref = np.asarray(jax_leaf(jmodel, name))
        p = p.detach()
        if name.endswith('q_sqrt'):
            ref, p = np.tril(ref), torch.tril(p)
        np.testing.assert_allclose(p.numpy(), ref, rtol=rtol,
                                   atol=floor * np.abs(ref).max() + 1e-12,
                                   err_msg=f'{what} {name}')


def _model_and_data(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == 'conv':
        flags, image = small_flags(), SMALL_IMAGE
    else:
        flags, image = RBF_FLAGS, RBF_IMAGE
    X = rng.randn(96, *image)
    Y = rng.randint(0, 10, size=(96, 1))
    model = jbuild(flags, X, Y, jax.random.PRNGKey(0), dtype=jnp.float64)
    # Away from the symmetric q_mu = 0 start, whose gradients cancel to
    # float64 noise that Adam's normalisation would amplify.
    prng = np.random.RandomState(100)
    model = model.replace(layers=tuple(
        layer.replace(q_mu=layer.q_mu + 0.05 * jnp.asarray(
            prng.randn(*layer.q_mu.shape))) for layer in model.layers))
    return model, flags, image, X.reshape(96, -1), Y


@pytest.mark.parametrize('kind', ['conv', 'rbf'])
def test_natgrad_trajectory_matches_jax(kind):
    """5 NatGrad steps (natural gradient on q_mu/q_sqrt, Adam on the rest)
    against the JAX package's ``train_step`` in float64: ELBO, every
    parameter, the verified copy ``prev`` and ``steps_back`` at rtol 1e-6
    with an absolute floor of 1e-7 of the array's largest magnitude (the
    Adam trajectory's rule: Adam's normalisation amplifies float64-level
    gradient differences on near-zero elements).  Both sides take the
    library route of ``natgrad_update`` (float64)."""
    model, flags, image, Xd, Y = _model_and_data(kind, 0 if kind == 'conv' else 3)
    config = jtrainer.TrainConfig(optimizer='NatGrad', lr=0.01, batch_size=8,
                                  gamma=0.01)
    state_j = jtrainer.init_state(model, config, jax.random.PRNGKey(1))
    step_j = jax.jit(lambda s, x, y: jtrainer.train_step(s, config, x, y))
    port = port_of(model, flags, image)
    tconfig = trainer.TrainConfig(optimizer='NatGrad', lr=0.01, batch_size=8,
                                  gamma=0.01)
    state = trainer.init_state(port, tconfig)
    assert not any(k.endswith(('q_mu', 'q_sqrt')) for k in state.opt_state['mu'])
    key = state_j.key
    brng = np.random.RandomState(2)
    for t in range(5):
        idx = brng.randint(0, 96, size=8)
        key, k_mc = jax.random.split(key)
        noise = jax_draws(state_j.model, k_mc, 8)
        state_j, elbo_j = step_j(state_j, jnp.asarray(Xd[idx]), jnp.asarray(Y[idx]))
        elbo = trainer.train_step(state, tconfig, torch.as_tensor(Xd[idx]),
                                  torch.as_tensor(Y[idx]), noise=noise)
        np.testing.assert_allclose(float(elbo), float(elbo_j), rtol=1e-6,
                                   err_msg=f'step {t}')
        _assert_params_close(state.params, state_j.model, 1e-6, 1e-7, f'step {t}')
        _assert_params_close(state.prev, state_j.prev_model, 1e-6, 1e-7,
                             f'prev {t}')
        assert float(state.steps_back) == float(state_j.steps_back) == 0.0
    assert int(state.step) == 5 and int(state.opt_state['count']) == 5


def test_natgrad_f32_step_through_kernel_paths(monkeypatch):
    """One float32 NatGrad step on a one-layer M=64 conv-GP (ConvKernel over
    9x9x3 images, 3x3 patches), the JAX package forced through its Pallas
    kernels (interpret mode: K1, K4, K5 and the K2 driver) and the port
    through their plain versions: one K1 and one K3 call for the M=64
    gram, one K4, one K5, and one K2 and one K3 for the [10, 64, 64]
    update's solve (on G's lower triangle, no K1).  The ELBO to 3e-4
    relative (each float32 ELBO sits up to 2e-4 from the float64 one on
    this k-means-initialised Kuu, rounding in other orders); the
    natural-gradient half -- q_mu and q_sqrt after the step -- to 1e-4 of
    each array's largest magnitude: the proposal moves them by
    gamma = 1e-3 times terms whose gradients agree to 5e-3 of their scale,
    so the float32 rounding of the parameters themselves dominates."""
    monkeypatch.setenv('DEEPCGP_PALLAS_FORCE', '1')
    monkeypatch.setenv('DEEPCGP_PALLAS_CROSS', '1')
    calls = {'k1': 0, 'k2': 0, 'k3': 0, 'k4': 0, 'k5': 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for mod, attr, name in ((cuda_linalg, 'chol_factor_blocked_plain', 'k1'),
                            (cuda_linalg, 'chol_upper_blocked_plain', 'k2'),
                            (cuda_linalg, 'tri_inv_blocked_plain', 'k3'),
                            (cuda_cross, 'conv_rbf_cross_plain', 'k4'),
                            (cuda_cross, 'conv_rbf_cross_bwd_plain', 'k5')):
        monkeypatch.setattr(mod, attr, count(name, getattr(mod, attr)))
    image = (9, 9, 3)
    flags = BuilderFlags(M='64', feature_maps='', filter_sizes='3',
                         strides='1', num_samples=3, batch_size=8)
    rng = np.random.RandomState(2)
    X = rng.randn(48, *image)
    Y = rng.randint(0, 10, size=(48, 1))
    model = jbuild(flags, X, Y, jax.random.PRNGKey(0), dtype=np.float64)
    M, R = model.layers[0].q_mu.shape
    q_sqrt = 0.3 * np.eye(M) + 0.05 * np.tril(rng.randn(R, M, M), -1)
    model = model.replace(layers=(model.layers[0].replace(
        q_mu=jnp.asarray(0.5 * rng.randn(M, R)), q_sqrt=jnp.asarray(q_sqrt)),))
    model = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, model)
    config = jtrainer.TrainConfig(optimizer='NatGrad', lr=0.01, batch_size=8)
    state_j = jtrainer.init_state(model, config, jax.random.PRNGKey(1))
    port = port_of(model, flags, image)
    tconfig = trainer.TrainConfig(optimizer='NatGrad', lr=0.01, batch_size=8)
    state = trainer.init_state(port, tconfig)
    xb = X[:8].reshape(8, -1).astype(np.float32)
    _, k_mc = jax.random.split(state_j.key)
    noise = jax_draws(state_j.model, k_mc, 8)
    step_j = jax.jit(lambda s, x, y: jtrainer.train_step(s, config, x, y))
    state_j, elbo_j = step_j(state_j, jnp.asarray(xb), jnp.asarray(Y[:8]))
    elbo = trainer.train_step(state, tconfig, torch.as_tensor(xb),
                              torch.as_tensor(Y[:8]), noise=noise)
    assert elbo.dtype == torch.float32
    np.testing.assert_allclose(float(elbo), float(elbo_j), rtol=3e-4)
    natgrad = {k: p for k, p in state.params.items() if k.endswith(('q_mu', 'q_sqrt'))}
    _assert_params_close(natgrad, state_j.model, 0, 1e-4, 'f32 step')
    assert calls == {'k1': 1, 'k2': 1, 'k3': 2, 'k4': 1, 'k5': 1}


def _probe_state(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(32, 8, 8, 1).astype(np.float32)
    Y = rng.randint(0, 10, size=(32, 1))
    flags = small_flags(M='4,4', feature_maps='2', filter_sizes='3,3',
                        strides='1,1', num_samples=2)
    model = build_model(flags, (8, 8, 1), images=X,
                        generator=torch.Generator().manual_seed(seed),
                        dtype=torch.float32, device='cpu')
    config = trainer.TrainConfig(optimizer='NatGrad', lr=0.01,
                                 lr_decay_steps=100, batch_size=8)
    state = trainer.init_state(model, config, seed=1)
    return state, config, torch.as_tensor(X.reshape(32, -1)), torch.as_tensor(Y)


def _snapshot(tensors: dict) -> dict:
    return {k: t.detach().clone() for k, t in tensors.items()}


def _assert_bit_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k].detach(), b[k].detach()), k


def test_natgrad_bad_batch_not_committed_and_bumps_gamma():
    """A non-finite loss commits neither half of the NatGrad step and grows
    steps_back; clean batches then train on (the JAX package's
    ``test_natgrad_bad_batch_not_committed_and_bumps_gamma``)."""
    state, config, X, Y = _probe_state()
    before = _snapshot(state.params)
    moments = _snapshot(state.opt_state['mu'])
    xb = X[:8].clone()
    xb[0, 0] = float('nan')
    elbo = trainer.train_step(state, config, xb, Y[:8])
    assert not torch.isfinite(elbo)
    _assert_bit_equal(state.params, before)
    _assert_bit_equal(state.opt_state['mu'], moments)
    assert float(state.steps_back) == 1.0 and int(state.opt_state['count']) == 0
    trace = trainer.run_chunk(state, config, X, Y, 3)
    assert torch.isfinite(trace).all()
    assert float(state.steps_back) == 1.0


def test_natgrad_deferred_rollback_restores_last_verified_params():
    """A committed state whose ELBO turns out non-finite is rolled back to
    ``prev``, the last verified parameters, by the next step's loss (the
    JAX package's ``test_natgrad_deferred_rollback_restores_last_verified_
    params``): the parameters equal ``prev`` bit for bit, and training
    continues."""
    state, config, X, Y = _probe_state()
    trainer.run_chunk(state, config, X, Y, 2)
    prev = _snapshot(state.prev)
    assert state.prev['layers.0.q_mu'].abs().max() > 0   # a trained state
    with torch.no_grad():
        state.params['layers.0.q_sqrt'].fill_(1e30)        # finite, poisonous
    elbo = trainer.train_step(state, config, X[:8], Y[:8])
    assert not torch.isfinite(elbo)
    _assert_bit_equal(state.params, prev)
    _assert_bit_equal(state.prev, prev)
    assert float(state.steps_back) == 1.0
    assert torch.isfinite(trainer.run_chunk(state, config, X, Y, 3)).all()


def test_run_chunk_terminal_verification_rolls_back(monkeypatch):
    """The last commit of a chunk is verified by one more ELBO: a finite but
    poisonous proposal committed by the chunk's last step is rolled back
    to the parameters before that step; a good chunk keeps its last step."""
    state, config, X, Y = _probe_state()
    trainer.run_chunk(state, config, X, Y, 2)
    before = _snapshot(state.params)
    real = optim.natgrad_step_with_backoff

    def poisonous(params, grads, gamma, steps_back):
        new, sb, ok = real(params, grads, gamma, steps_back)
        return [(mu, torch.full_like(W, 1e30)) for mu, W in new], sb, ok

    monkeypatch.setattr(optim, 'natgrad_step_with_backoff', poisonous)
    trace = trainer.run_chunk(state, config, X, Y, 1)
    assert torch.isfinite(trace).all()          # the step's own loss was fine
    _assert_bit_equal(state.params, before)
    monkeypatch.setattr(optim, 'natgrad_step_with_backoff', real)
    trainer.run_chunk(state, config, X, Y, 1)
    assert not torch.equal(state.params['layers.1.q_mu'], before['layers.1.q_mu'])


# ------------------------------------------------------------ ARD-RBF last layer


def _rbf_model(seed=5, N=40):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, *RBF_IMAGE)
    Y = rng.randint(0, 10, size=(N, 1))
    model = jbuild(RBF_FLAGS, X, Y, jax.random.PRNGKey(seed), dtype=jnp.float64)
    layer = model.layers[0]
    M, R = layer.q_mu.shape
    q_sqrt = 0.3 * np.eye(M) + 0.05 * np.tril(rng.randn(R, M, M), -1)
    ls = 4.0 + rng.rand(layer.kernel.raw_lengthscales.shape[0])
    layer = layer.replace(q_mu=jnp.asarray(0.5 * rng.randn(M, R)),
                          q_sqrt=jnp.asarray(q_sqrt),
                          kernel=layer.kernel.replace(
                              raw_lengthscales=jnp.log(jnp.expm1(jnp.asarray(ls)))))
    return model.replace(layers=(layer,)), X.reshape(N, -1), Y


def test_rbf_last_layer_elbo_and_gradients_f64_match_jax():
    """The single-layer ARD-RBF model (no hidden layer, M = 16 over 36
    pixels): ELBO and all five gradients at float64 rtol 1e-9."""
    model, X, Y = _rbf_model()
    key = jax.random.PRNGKey(7)
    noise = jax_draws(model, key, 10)
    elbo_j, grads_j = jax.jit(jax.value_and_grad(
        lambda m: m.elbo(jnp.asarray(X[:10]), jnp.asarray(Y[:10]), key)))(model)
    port = port_of(model, RBF_FLAGS, RBF_IMAGE)
    params = dict(port.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    elbo = port.elbo(torch.as_tensor(X[:10]), torch.as_tensor(Y[:10]), noise=noise)
    grads = torch.autograd.grad(elbo, list(params.values()))
    np.testing.assert_allclose(float(elbo.detach()), float(elbo_j), rtol=1e-9)
    assert sorted(params) == ['layers.0.Z', 'layers.0.kernel.raw_lengthscales',
                              'layers.0.kernel.raw_variance', 'layers.0.q_mu',
                              'layers.0.q_sqrt']
    for name, g in zip(params, grads):
        ref = np.asarray(jax_leaf(grads_j, name))
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=name)


def test_rbf_last_layer_round_trips():
    """Convert (JAX -> port), snapshot (port -> reference pathnames) and
    back through the JAX builder keep every value of the ARD layer; the
    plain kernel's snapshot keys are the un-prefixed 'kern/variance' and
    'kern/lengthscales'; and a fresh port build from images initialises
    it (lengthscales 5 over every pixel, q_sqrt = chol(Kuu))."""
    model, X, Y = _rbf_model()
    port = port_of(model, RBF_FLAGS, RBF_IMAGE)
    ours = checkpoint.model_parameters(port, 3)
    ref = jckpt.model_parameters(model, 3)
    assert sorted(ours) == sorted(ref)
    assert 'DGP/layers/0/kern/lengthscales' in ours
    for k in ref:
        np.testing.assert_allclose(np.asarray(ours[k]), np.asarray(ref[k]),
                                   rtol=1e-12, err_msg=k)
    _, layer_params = jckpt.parse_layer_parameters(ours, 1)
    back = jbuild(RBF_FLAGS, X.reshape(-1, *RBF_IMAGE), Y, jax.random.PRNGKey(0),
                  loaded_parameters=layer_params, dtype=jnp.float64)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(model)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)
    fresh = build_model(RBF_FLAGS, RBF_IMAGE, images=X,
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.float64, device='cpu')
    layer = fresh.layers[0]
    assert tuple(layer.Z.shape) == (16, 36) and len(fresh.layers) == 1
    np.testing.assert_allclose(layer.kernel.lengthscales.detach().numpy(),
                               np.full(36, 5.0), rtol=1e-12)
    Lu = torch.linalg.cholesky(layer.Kuu(layer.Z))
    torch.testing.assert_close(layer.q_sqrt.detach(), Lu.expand(10, 16, 16))


def test_kmeans_plusplus():
    """k-means++ seeds distinct data rows, and Lloyd from the JAX package's
    k-means++ seeds matches its ``kmeans(init='k-means++')`` (float64,
    rtol 1e-10)."""
    rng = np.random.RandomState(9)
    X = np.concatenate([rng.randn(60, 5) + 4 * rng.randn(1, 5) for _ in range(4)])
    Xt = torch.as_tensor(X)
    seeds = _plusplus_init(Xt, 12, torch.Generator().manual_seed(3))
    rows = {tuple(r) for r in X}
    assert len({tuple(c) for c in seeds.numpy()}) == 12
    assert all(tuple(c) in rows for c in seeds.numpy())
    key = jax.random.PRNGKey(4)
    jseeds = np.asarray(jkmeans._plusplus_init(key, jnp.asarray(X), 12))
    ref = jkmeans.kmeans(key, jnp.asarray(X), 12, iters=20, init='k-means++')
    ours = kmeans(Xt, 12, 20, centers=torch.as_tensor(jseeds))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    fresh = kmeans(Xt, 12, 20, generator=torch.Generator().manual_seed(0),
                   init='k-means++')
    assert tuple(fresh.shape) == (12, 5) and torch.isfinite(fresh).all()
