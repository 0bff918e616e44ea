"""The PyTorch port's training slice against the JAX package on the CPU:
the whole-model ELBO and every trainable gradient (float64, and float32
through the kernel paths with the JAX package's Pallas kernels in
interpret mode), a short Adam trajectory against ``trainer.train_step``,
the commit guard, the frozen KL anchor Z0, the learning-rate schedule and
Adam against optax, and the train -> snapshot -> Predictor round trip.
Both sides get the same parameters, minibatches and Monte-Carlo noise."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepcgp_tpu.models import dgp as jdgp
from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.models.layers import ConvLayer as JConvLayer
from deepcgp_tpu.training import optim as joptim
from deepcgp_tpu.training import trainer as jtrainer
from deepcgp_tpu.utils import checkpoint as jckpt

from deepcgp_tpu_torch.convert import from_jax_parameters
from deepcgp_tpu_torch.models.builder import build_model
from deepcgp_tpu_torch.ops import cuda_cross, cuda_linalg
from deepcgp_tpu_torch.serving import Predictor
from deepcgp_tpu_torch.training import optim, trainer
from deepcgp_tpu_torch.utils import checkpoint

KERNEL_IMAGE = (12, 12, 3)
KERNEL_FLAGS = BuilderFlags(M='64,64', feature_maps='3', filter_sizes='3,3',
                            strides='2,1', num_samples=3, batch_size=8)
SMALL_IMAGE = (12, 12, 1)


def small_flags(white=False):
    return BuilderFlags(M='6,8', feature_maps='2', filter_sizes='5,3',
                        strides='2,1', num_samples=3, batch_size=8, white=white)


def jax_draws(model, key, N):
    """The standard normals ``dgp.propagate`` draws for N rows and the
    model's num_samples: one key split per layer, then ``mc_normal``."""
    out = []
    for layer in model.layers:
        key, sub = jax.random.split(key)
        out.append(np.array(jdgp.mc_normal(
            sub, (model.num_samples, N, layer.num_outputs), layer.q_mu.dtype)))
    return out


def port_of(model, flags, image, device='cpu'):
    params = jckpt.model_parameters(model, 0)
    Z0 = [np.asarray(l.Z0) for l in model.layers if isinstance(l, JConvLayer)]
    return from_jax_parameters(flags, image, params, Z0,
                               num_data=model.num_data, device=device)


def jax_leaf(model, name):
    """The JAX model's leaf for a port parameter name."""
    _, i, *path = name.split('.')
    node = model.layers[int(i)]
    for part in path:
        node = getattr(node, part)
    return node


@functools.lru_cache(maxsize=None)
def _kernel_model64():
    """The 2-layer M=64 model (one K1 panel, K4/K5 geometry) with
    trained-looking variational parameters and patch weights."""
    rng = np.random.RandomState(2)
    X = rng.randn(48, *KERNEL_IMAGE)
    Y = rng.randint(0, 10, size=(48, 1))
    model = jbuild(KERNEL_FLAGS, X, Y, jax.random.PRNGKey(0), dtype=np.float64)
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


def _elbo_and_grads(dtype):
    model, X, Y = _kernel_model64()
    if dtype == np.float32:
        model = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, model)
    Xb, Yb = X[:10].astype(dtype), Y[:10]
    key = jax.random.PRNGKey(7)
    noise = jax_draws(model, key, 10)
    elbo_j, grads_j = jax.jit(jax.value_and_grad(
        lambda m, x, y: m.elbo(x, y, key)))(model, jnp.asarray(Xb),
                                             jnp.asarray(Yb))
    port = port_of(model, KERNEL_FLAGS, KERNEL_IMAGE)
    params = dict(port.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    elbo = port.elbo(torch.as_tensor(Xb), torch.as_tensor(Yb), noise=noise)
    grads = torch.autograd.grad(elbo, list(params.values()))
    return elbo_j, grads_j, elbo, dict(zip(params, grads))


def test_elbo_and_gradients_f64_match_jax():
    elbo_j, grads_j, elbo, grads = _elbo_and_grads(np.float64)
    np.testing.assert_allclose(float(elbo.detach()), float(elbo_j), rtol=1e-9)
    assert len(grads) == 11
    for name, g in grads.items():
        ref = np.asarray(jax_leaf(grads_j, name))
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=name)
    # JAX's anchor gets no gradient either (stop_gradient).
    assert not np.asarray(grads_j.layers[0].Z0).any()


def test_elbo_and_gradients_f32_through_kernel_paths(monkeypatch):
    """float32 with the JAX package forced through its Pallas kernels
    (interpret mode) -- K1's driver, K4 and K5 -- and the port through
    their plain versions.  The ELBO to 1e-4 relative (the two float32
    ELBOs sit 1.5e-4 and 2.1e-4 from the float64 one, and JAX's own moves
    by 3e-5 between eager and jitted evaluation) and each gradient to 5e-3
    of its leaf's largest magnitude.  The k-means Kuu of this model is
    ill-conditioned: each float32 side is up to 1.27 times the leaf's
    scale away from the float64 gradient (hidden Z) on its own, and the
    two sides, rounding in other orders, agree to 1.7e-3 (last-layer Z)
    and 3.6e-3 (last-layer variance), the port nearer the float64 value
    on the latter."""
    monkeypatch.setenv('DEEPCGP_PALLAS_FORCE', '1')
    monkeypatch.setenv('DEEPCGP_PALLAS_CROSS', '1')
    calls = {'k1': 0, 'k3': 0, 'k4': 0, 'k5': 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(cuda_linalg, 'chol_factor_blocked_plain',
                        count('k1', cuda_linalg.chol_factor_blocked_plain))
    monkeypatch.setattr(cuda_linalg, 'tri_inv_blocked_plain',
                        count('k3', cuda_linalg.tri_inv_blocked_plain))
    monkeypatch.setattr(cuda_cross, 'conv_rbf_cross_plain',
                        count('k4', cuda_cross.conv_rbf_cross_plain))
    monkeypatch.setattr(cuda_cross, 'conv_rbf_cross_bwd_plain',
                        count('k5', cuda_cross.conv_rbf_cross_bwd_plain))
    elbo_j, grads_j, elbo, grads = _elbo_and_grads(np.float32)
    assert elbo.dtype == torch.float32
    np.testing.assert_allclose(float(elbo), float(elbo_j), rtol=1e-4)
    for name, g in grads.items():
        ref = np.asarray(jax_leaf(grads_j, name))
        err = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 5e-3, (name, err)
    # One K1 and one K3 call for the three M=64 grams, one K4, one K5.
    assert calls == {'k1': 1, 'k3': 1, 'k4': 1, 'k5': 1}


def _trajectory(white, optimizer='Adam', steps=5, lr=0.01):
    rng = np.random.RandomState(4 if white else 0)
    X = rng.randn(96, *SMALL_IMAGE)
    Y = rng.randint(0, 10, size=(96, 1))
    flags = small_flags(white)
    model = jbuild(flags, X, Y, jax.random.PRNGKey(0), dtype=jnp.float64)
    # Away from the symmetric q_mu = 0 start, whose gradients cancel to
    # f64 noise that Adam's normalisation would amplify (shared by both).
    prng = np.random.RandomState(100)
    model = model.replace(layers=tuple(
        layer.replace(q_mu=layer.q_mu + 0.05 * jnp.asarray(
            prng.randn(*layer.q_mu.shape))) for layer in model.layers))
    config = jtrainer.TrainConfig(optimizer=optimizer, lr=lr, batch_size=8)
    state_j = jtrainer.init_state(model, config, jax.random.PRNGKey(1))
    step_j = jax.jit(lambda s, x, y: jtrainer.train_step(s, config, x, y))
    port = port_of(model, flags, SMALL_IMAGE)
    tconfig = trainer.TrainConfig(optimizer=optimizer, lr=lr, batch_size=8)
    state = trainer.init_state(port, tconfig)
    Xd = X.reshape(96, -1)
    key = state_j.key
    brng = np.random.RandomState(2)
    for t in range(steps):
        idx = brng.randint(0, 96, size=8)
        key, k_mc = jax.random.split(key)
        noise = jax_draws(state_j.model, k_mc, 8)
        state_j, elbo_j = step_j(state_j, jnp.asarray(Xd[idx]), jnp.asarray(Y[idx]))
        elbo = trainer.train_step(state, tconfig, torch.as_tensor(Xd[idx]),
                                  torch.as_tensor(Y[idx]), noise=noise)
        yield t, state_j, float(elbo_j), state, float(elbo)


@pytest.mark.parametrize('white,optimizer', [(False, 'Adam'), (True, 'Adam'),
                                              (False, 'SGD')])
def test_adam_trajectory_matches_jax(white, optimizer):
    """5 Adam (and plain SGD) steps against the JAX package's
    ``train_step`` in float64:
    ELBO and every parameter at rtol 1e-6, with an absolute floor of 1e-7
    times the array's largest magnitude (tests/test_trajectory_parity.py's
    rule: Adam's sqrt(v) + eps normalisation amplifies f64-level gradient
    differences on near-zero elements).

    Plain SGD takes lr 1e-4: at 0.01 its second step throws layer 0's
    lengthscale to the positive bound 1e-6 and its variance to ~1.5e4, a
    state whose Kuu diagonal is set by the rounding residue of
    ||Z / lengthscale||^2 (~2.5e13; JAX's self-distance reads 9.8e-4
    where the port's and the exact one read 0), so the two ELBOs at
    identical leaves part by 2.6e-5 as each machine's BLAS rounds (with
    JAX's self-distance put into the port, or the exact 0 diagonal into
    both, they agree to 2e-16: tools/torch_sgd_witness.py).  Every
    ELBO stays within a factor of 2 of step 0's, so a trajectory that
    drifts back into such a state fails here first."""
    lr = 1e-4 if optimizer == 'SGD' else 0.01
    elbo0 = None
    for t, state_j, elbo_j, state, elbo in _trajectory(white, optimizer,
                                                        lr=lr):
        elbo0 = elbo_j if elbo0 is None else elbo0
        assert 0.5 * abs(elbo0) <= abs(elbo_j) <= 2.0 * abs(elbo0), (
            f'step {t}: ELBO {elbo_j} left a factor of 2 of step 0 ({elbo0})')
        np.testing.assert_allclose(elbo, elbo_j, rtol=1e-6, err_msg=f'step {t}')
        for name, p in state.params.items():
            ref = np.asarray(jax_leaf(state_j.model, name))
            if name.endswith('q_sqrt'):
                ref = np.tril(ref)
                p = torch.tril(p)
            np.testing.assert_allclose(
                p.detach().numpy(), ref, rtol=1e-6,
                atol=1e-7 * np.abs(ref).max() + 1e-12,
                err_msg=f'step {t} {name}')
    assert int(state.step) == 5
    assert optimizer == 'SGD' or int(state.opt_state['count']) == 5


def _small_port(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(64, *SMALL_IMAGE)
    Y = rng.randint(0, 10, size=(64, 1))
    model = build_model(small_flags(), SMALL_IMAGE, images=X,
                        generator=torch.Generator().manual_seed(seed),
                        dtype=torch.float64, device='cpu')
    return model, torch.as_tensor(X.reshape(64, -1)), torch.as_tensor(Y)


def test_commit_guard_leaves_state_bit_equal():
    """A step whose loss or gradients are non-finite (NaN noise here)
    commits nothing: parameters and Adam moments stay bit-equal and the
    Adam count does not advance; the NaN shows in the ELBO trace."""
    model, X, Y = _small_port()
    config = trainer.TrainConfig(batch_size=8)
    state = trainer.init_state(model, config, seed=3)
    trainer.run_chunk(state, config, X, Y, 2)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    moments = {k: (state.opt_state['mu'][k].clone(), state.opt_state['nu'][k].clone())
               for k in state.params}
    S = model.num_samples
    noise = [torch.full((S, 8, layer.num_outputs), float('nan'),
                        dtype=torch.float64) for layer in model.layers]
    elbo = trainer.train_step(state, config, X[:8], Y[:8], noise=noise)
    assert not torch.isfinite(elbo)
    for k, p in state.params.items():
        assert torch.equal(p.detach(), before[k]), k
        assert torch.equal(state.opt_state['mu'][k], moments[k][0]), k
        assert torch.equal(state.opt_state['nu'][k], moments[k][1]), k
    assert int(state.opt_state['count']) == 2 and int(state.step) == 3
    trace = trainer.run_chunk(state, config, X, Y, 2)
    assert torch.isfinite(trace).all()
    assert not torch.equal(state.params['layers.1.q_mu'].detach(),
                           before['layers.1.q_mu'])


def test_kl_anchor_z0_is_frozen():
    """The hidden layer's KL anchor Z0 is a buffer: outside the trainable
    set, unchanged by training steps that move Z, and the prior KL sends
    no gradient to Z (the JAX package's stop_gradient(Z0)).  Before, Z0
    was the same tensor as Z, so the KL pulled Z and the anchor moved with
    every update."""
    model, X, Y = _small_port(1)
    hidden = model.layers[0]
    Z_init = hidden.Z.detach().clone()
    assert 'layers.0.Z0' in dict(model.named_buffers())
    assert 'layers.0.Z0' not in dict(model.named_parameters())
    assert hidden.Z0.data_ptr() != hidden.Z.data_ptr()
    config = trainer.TrainConfig(batch_size=8)
    state = trainer.init_state(model, config, seed=4)
    assert not hidden.Z0.requires_grad
    trainer.run_chunk(state, config, X, Y, 3)
    assert not torch.equal(hidden.Z.detach(), Z_init)
    assert torch.equal(hidden.Z0, Z_init)
    kl = model.prior_kl(model.precompute())
    gZ, = torch.autograd.grad(kl, [hidden.Z], allow_unused=True)
    assert gZ is None or not gZ.any()


@pytest.mark.parametrize('staircase', [True, False])
def test_learning_rate_schedule_matches_optax(staircase):
    ref = joptim.learning_rate_schedule(0.01, 100, staircase=staircase)
    ours = optim.learning_rate_schedule(0.01, 100, staircase=staircase)
    for step in (0, 1, 57, 99, 100, 150, 1000, 12345):
        np.testing.assert_allclose(
            float(ours(torch.tensor(step), torch.float64)), float(ref(step)),
            rtol=1e-6, err_msg=str(step))


def test_adam_matches_optax():
    rng = np.random.RandomState(5)
    shapes = {'a': (3, 4), 'b': ()}
    params = {k: torch.zeros(s, dtype=torch.float64) for k, s in shapes.items()}
    state = optim.adam_init(params)
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    ostate = tx.init({k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(4):
        g = {k: np.asarray(rng.randn(*s)) for k, s in shapes.items()}
        upd, state['mu'], state['nu'], state['count'] = optim.adam_updates(
            {k: torch.tensor(v) for k, v in g.items()}, state)
        oupd, ostate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, ostate)
        for k in shapes:
            np.testing.assert_allclose(upd[k].numpy(), np.asarray(oupd[k]),
                                       rtol=1e-12)


def test_train_save_serve_round_trip(tmp_path):
    """A trained model saves as a reference snapshot that
    ``Predictor.from_run_dir`` serves: the same parameters, and
    probabilities that are finite and sum to 1."""
    model, X, Y = _small_port(2)
    config = trainer.TrainConfig(batch_size=8)
    state = trainer.init_state(model, config, seed=5)
    trainer.run_chunk(state, config, X, Y, 3)
    root = str(tmp_path)
    checkpoint.save_model(os.path.join(root, 'run.npy'), model, int(state.step))
    run = os.path.join(root, 'run')
    os.makedirs(run)
    flags = small_flags()
    with open(os.path.join(run, 'options.toml'), 'w') as f:
        f.write('name = "run"\n')
        for k in ('M', 'feature_maps', 'filter_sizes', 'strides',
                  'base_kernel', 'last_kernel'):
            f.write(f'{k} = "{getattr(flags, k)}"\n')
        f.write('white = false\nidentity_mean = false\nnum_samples = 3\n')
    pred = Predictor.from_run_dir(run, SMALL_IMAGE, batch_size=8, num_samples=3,
                                  dtype=torch.float64, device='cpu')
    for (name, p), q in zip(model.named_parameters(), pred.model.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    probs = pred.predict_proba(X[:13].numpy())
    assert probs.shape == (13, 10) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=5e-3)
    assert 0.0 <= trainer.accuracy(model, X[:16].numpy(), Y[:16].numpy()) <= 1.0
