"""The port's unfused last-layer route against the JAX package on the CPU:
the geometries the fused cross-covariance (K4/K5) does not take -- a last
layer with L > 512 and an ARD-lengthscale last layer -- through the
transposed-order extraction (K6) and its col2im (K7), and the two with
P > 64 that the row-tiled image side brought onto the fused route -- an
MNIST-shaped single-layer ConvKernel and a 2-layer model -- on both
routes, the fused one as the gate chooses and the unfused one forced.  The
whole-model ELBO and every gradient in float64 and in float32 (the JAX
package's Pallas kernels in interpret mode, the port's plain versions),
Adam and NatGrad steps against ``trainer.train_step``, the route each
geometry takes, and the train -> snapshot -> Predictor round trip.  Both sides get the same
parameters (random, non-uniform patch weights), minibatches and
Monte-Carlo noise."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models import dgp as jdgp
from deepcgp_tpu.models.base_kernels import RBF as JRBF
from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.models.layers import ConvLayer as JConvLayer
from deepcgp_tpu.training import trainer as jtrainer
from deepcgp_tpu.utils import checkpoint as jckpt

from deepcgp_tpu_torch.convert import from_jax_parameters
from deepcgp_tpu_torch.models.base_kernels import RBF
from deepcgp_tpu_torch.models.builder import build_model
from deepcgp_tpu_torch.models.conv_kernels import AdditivePatchKernel, ConvKernel
from deepcgp_tpu_torch.models.views import FullView
from deepcgp_tpu_torch.ops import cuda_cross, cuda_patches
from deepcgp_tpu_torch.serving import Predictor
from deepcgp_tpu_torch.training import trainer
from deepcgp_tpu_torch.utils import checkpoint, profiling

# name: (flags, image, last-layer lengthscale) -- (P, L) of the last layer.
GEOMETRIES = {
    # MNIST's single-layer ConvKernel, narrowed: P = 100, L = 25.
    'mnist': (BuilderFlags(M='16', feature_maps='', filter_sizes='5',
                           strides='1', num_samples=3, batch_size=8),
              (14, 14, 1), 'scalar'),
    # The fm32 family: 21 feature maps, P = 4, L = 525 > 512.
    'wide': (BuilderFlags(M='8,8', feature_maps='21', filter_sizes='3,5',
                          strides='2,1', num_samples=2, batch_size=6),
             (14, 14, 1), 'scalar'),
    # The strides-2,1 family: P = 81 > 64, L = 18.
    'strided': (BuilderFlags(M='8,8', feature_maps='2', filter_sizes='3,3',
                             strides='2,1', num_samples=2, batch_size=6),
                (24, 24, 1), 'scalar'),
    # ARD lengthscales on a geometry the fused pair takes: P = 9, L = 27.
    'ard': (BuilderFlags(M='8,8', feature_maps='3', filter_sizes='3,3',
                         strides='2,1', num_samples=2, batch_size=6),
            (12, 12, 3), 'ard'),
}
NUM_IMAGES = 48
# The geometries the gate sends fused (P > 64 on the row-tiled image
# side); each also runs unfused, forced, as '<name>-unfused'.
FUSED = ('mnist', 'strided')
ROUTED = sorted(GEOMETRIES) + [f'{name}-unfused' for name in FUSED]


def routed(name, monkeypatch):
    """(geometry, whether the last layer takes the fused route): a
    '-unfused' name forces the unfused route, ``fused_fits`` answering
    False inside the test."""
    name, _, forced = name.partition('-')
    if forced:
        monkeypatch.setattr(cuda_cross, 'fused_fits', lambda kernel: False)
    return name, name in FUSED and not forced


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


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """The JAX model of a geometry in float64, with trained-looking
    variational parameters, random patch weights and a last-layer
    lengthscale of 2 sqrt(L) (ARD: that times U(0.5, 1.5) per element),
    which keeps its cross-covariances away from underflow."""
    flags, image, ls_kind = GEOMETRIES[name]
    rng = np.random.RandomState(sorted(GEOMETRIES).index(name))
    X = rng.randn(NUM_IMAGES, *image)
    Y = rng.randint(0, 10, size=(NUM_IMAGES, 1))
    model = jbuild(flags, X, Y, jax.random.PRNGKey(0), dtype=np.float64)
    layers = []
    for layer in model.layers:
        M, R = layer.q_mu.shape
        q_sqrt = 0.3 * np.eye(M) + 0.05 * np.tril(rng.randn(R, M, M), -1)
        layer = layer.replace(q_mu=jnp.asarray(0.5 * rng.randn(M, R)),
                              q_sqrt=jnp.asarray(q_sqrt))
        if hasattr(layer, 'kernel'):
            L = layer.kernel.view.patch_length
            ls = 2.0 * np.sqrt(L)
            if ls_kind == 'ard':
                ls = ls * (0.5 + rng.rand(L))
            base = JRBF.create(variance=2.5, lengthscales=ls, dtype=jnp.float64)
            w = rng.rand(layer.kernel.patch_weights.shape[0]) + 0.5
            layer = layer.replace(kernel=layer.kernel.replace(
                base_kernel=base, patch_weights=jnp.asarray(w)))
        layers.append(layer)
    return model.replace(layers=tuple(layers)), X.reshape(NUM_IMAGES, -1), Y


def _elbo_and_grads(name, dtype):
    flags, image, _ = GEOMETRIES[name]
    model, X, Y = _jax_model(name)
    if dtype == np.float32:
        model = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, model)
    B = 10
    Xb, Yb = X[:B].astype(dtype), Y[:B]
    key = jax.random.PRNGKey(7)
    noise = jax_draws(model, key, B)
    elbo_j, grads_j = jax.jit(jax.value_and_grad(
        lambda m, x, y: m.elbo(x, y, key)))(model, jnp.asarray(Xb),
                                             jnp.asarray(Yb))
    port = port_of(model, flags, image)
    params = dict(port.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    elbo = port.elbo(torch.as_tensor(Xb), torch.as_tensor(Yb), noise=noise)
    grads = torch.autograd.grad(elbo, list(params.values()))
    return elbo_j, grads_j, elbo, dict(zip(params, grads)), port


@pytest.mark.parametrize('name', ROUTED)
def test_elbo_and_gradients_f64_match_jax(name, monkeypatch):
    """float64, the JAX package on its transposed-order Pallas extraction
    (interpret mode) and its unfused route, the port on the route its gate
    chooses (or forced unfused): the ELBO and every gradient to 1e-9, with
    an absolute floor of 1e-9 times the leaf's largest magnitude."""
    monkeypatch.setenv('DEEPCGP_PALLAS_EXTRACT', '1')
    name, fused = routed(name, monkeypatch)
    elbo_j, grads_j, elbo, grads, port = _elbo_and_grads(name, np.float64)
    assert cuda_cross.fused_fits(port.layers[-1].kernel) == fused
    np.testing.assert_allclose(float(elbo.detach()), float(elbo_j), rtol=1e-9)
    assert len(grads) == 5 * len(port.layers) + 1
    for key, g in grads.items():
        ref = np.asarray(jax_leaf(grads_j, key))
        assert np.abs(ref).max() > 0, key
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=key)


@pytest.mark.parametrize('name', ROUTED)
def test_elbo_and_gradients_f32_through_kernel_paths(name, monkeypatch):
    """float32 with the JAX package forced through its Pallas kernels
    (interpret mode), its unfused route's extraction and col2im among
    them, and the port through their plain versions; the tolerances of
    tests/test_torch_training.py's float32 test: the ELBO to 1e-4
    relative, each gradient to 5e-3 of its leaf's largest magnitude.  Per
    ELBO the port's unfused route extracts once (K6), calls K7 once where
    the image is a hidden layer's samples and not at all where it is data,
    and never takes the fused kernels; its fused route takes K4 and K5
    once each and neither K6 nor K7 (K5's plain version forms d images
    itself)."""
    monkeypatch.setenv('DEEPCGP_PALLAS_FORCE', '1')
    monkeypatch.setenv('DEEPCGP_PALLAS_EXTRACT', '1')
    monkeypatch.setenv('DEEPCGP_PALLAS_CROSS', '0')
    name, fused = routed(name, monkeypatch)
    calls = {'k4': 0, 'k5': 0, 'k6': 0, 'k7': 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    for key, mod, fn in (('k4', cuda_cross, 'conv_rbf_cross_plain'),
                         ('k5', cuda_cross, 'conv_rbf_cross_bwd_plain'),
                         ('k6', cuda_patches, 'extract_patches_transposed_plain'),
                         ('k7', cuda_patches, 'col2im_transposed_plain')):
        monkeypatch.setattr(mod, fn, count(key, getattr(mod, fn)))
    elbo_j, grads_j, elbo, grads, port = _elbo_and_grads(name, np.float32)
    assert elbo.dtype == torch.float32
    np.testing.assert_allclose(float(elbo.detach()), float(elbo_j), rtol=1e-4)
    for key, g in grads.items():
        ref = np.asarray(jax_leaf(grads_j, key))
        err = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 5e-3, (key, err)
    hidden = len(port.layers) > 1
    if fused:
        assert calls == {'k4': 1, 'k5': 1, 'k6': 0, 'k7': 0}
    else:
        assert calls == {'k4': 0, 'k5': 0, 'k6': 1, 'k7': int(hidden)}


def test_routes():
    """fused_fits: the flagship's last layer is fused on the cluster image
    side; MNIST 28 x 28 (P = 576) and CIFAR with strides 2,1 (P = 100) are
    fused on the row-tiled one; the fm32 last layer (L = 800) and ARD
    lengthscales are unfused, on the CPU as on the card."""
    iso = RBF.create(5.0, 5.0, dtype=torch.float64)

    def kernel(H, C, f, base=iso, cls=ConvKernel):
        return cls.create(base, FullView(input_size=(H, H), filter_size=f,
                                         feature_maps=C), dtype=torch.float64)

    assert cuda_cross.fused_fits(kernel(10, 10, 5))
    assert cuda_cross.fused_fits(kernel(10, 10, 5, cls=AdditivePatchKernel))
    assert cuda_cross.bwd_route(36, 250) == 'cluster'
    assert cuda_cross.fused_fits(kernel(28, 1, 5))
    assert cuda_cross.bwd_route(576, 25) == 'tiled'
    assert not cuda_cross.fused_fits(kernel(10, 32, 5))
    assert cuda_cross.fused_fits(kernel(14, 10, 5))
    assert cuda_cross.bwd_route(100, 250) == 'tiled'
    ard = RBF.create(5.0, 5.0, ard_dim=250, dtype=torch.float64)
    assert not cuda_cross.fused_fits(kernel(10, 10, 5, base=ard))


def test_unfused_route_extracts_once_and_matches_fused():
    """On a geometry both routes take, the unfused pair equals the fused
    one (random weights, both kernel classes), Kzx_NM and Kzx agree with
    it, and the pair costs one extraction."""
    rng = np.random.RandomState(9)
    view = FullView(input_size=(9, 11), filter_size=3, feature_maps=3, stride=2)
    base = RBF.create(1.3, 2.0, dtype=torch.float64)
    X = torch.tensor(rng.randn(5, 9 * 11 * 3))
    Z = torch.tensor(rng.randn(7, view.patch_length))
    w = torch.tensor(rng.rand(view.patch_count) + 0.5)
    for cls in (ConvKernel, AdditivePatchKernel):
        k = cls(base, w, view)
        fused = cuda_cross.kzx_and_kdiag(k, Z, X)
        patches = k._patches(X)
        unfused = (k._cross(Z, patches), k.Kdiag(X, patches))
        for a, b in zip(unfused, fused):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)
        np.testing.assert_allclose(k.Kzx_NM(Z, X).numpy(), fused[0].numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(k.Kzx(Z, X).numpy(), fused[0].numpy().T,
                                   rtol=1e-12)


@pytest.mark.parametrize('cls', ['conv', 'add'])
def test_K_matches_jax(cls, monkeypatch):
    """The full-covariance K(X), K(X, X2) and Kdiag of both patch-sum
    kernels on the transposed-order extraction, against the JAX package's
    on its Pallas extraction, float64, random weights."""
    from deepcgp_tpu.models.conv_kernels import (AdditivePatchKernel as JAdd,
                                                 ConvKernel as JConv)
    from deepcgp_tpu.models.views import FullView as JFullView
    monkeypatch.setenv('DEEPCGP_PALLAS_EXTRACT', '1')
    jcls, tcls = {'conv': (JConv, ConvKernel),
                  'add': (JAdd, AdditivePatchKernel)}[cls]
    rng = np.random.RandomState(10)
    jview = JFullView(input_size=(9, 11), filter_size=3, feature_maps=2,
                      stride=2, dilation=2)
    jbase = JRBF.create(variance=1.3, lengthscales=2.0 + rng.rand(18),
                        dtype=jnp.float64)
    w = rng.rand(jview.patch_count) + 0.5
    jk = jcls.create(jbase, jview, patch_weights=jnp.asarray(w),
                     dtype=jnp.float64)
    assert jk._pallas_order()
    view = FullView(input_size=(9, 11), filter_size=3, feature_maps=2,
                    stride=2, dilation=2)
    tk = tcls(RBF(torch.tensor(np.asarray(jbase.raw_variance)),
                  torch.tensor(np.asarray(jbase.raw_lengthscales))),
              torch.tensor(w), view)
    X = rng.randn(5, 9 * 11 * 2)
    X2 = rng.randn(3, 9 * 11 * 2)
    pairs = ((tk.K(torch.tensor(X)), jk.K(jnp.asarray(X))),
             (tk.K(torch.tensor(X), torch.tensor(X2)),
              jk.K(jnp.asarray(X), jnp.asarray(X2))),
             (tk.Kdiag(torch.tensor(X)), jk.Kdiag(jnp.asarray(X))))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-13)


def _trajectory(optimizer, steps):
    """The MNIST-shaped model's first ``steps`` optimizer steps, the port
    against the JAX package's ``train_step`` in float64."""
    flags, image, _ = GEOMETRIES['mnist']
    model, X, Y = _jax_model('mnist')
    config = jtrainer.TrainConfig(optimizer=optimizer, lr=0.01, batch_size=8,
                                  gamma=0.01)
    state_j = jtrainer.init_state(model, config, jax.random.PRNGKey(1))
    step_j = jax.jit(lambda s, x, y: jtrainer.train_step(s, config, x, y))
    tconfig = trainer.TrainConfig(optimizer=optimizer, lr=0.01, batch_size=8,
                                  gamma=0.01)
    state = trainer.init_state(port_of(model, flags, image), tconfig)
    key = state_j.key
    brng = np.random.RandomState(2)
    for t in range(steps):
        idx = brng.randint(0, NUM_IMAGES, size=8)
        key, k_mc = jax.random.split(key)
        noise = jax_draws(state_j.model, k_mc, 8)
        state_j, elbo_j = step_j(state_j, jnp.asarray(X[idx]), jnp.asarray(Y[idx]))
        elbo = trainer.train_step(state, tconfig, torch.as_tensor(X[idx]),
                                  torch.as_tensor(Y[idx]), noise=noise)
        yield t, state_j, float(elbo_j), state, float(elbo)


@pytest.mark.parametrize('optimizer,steps', [('Adam', 5), ('NatGrad', 1)])
def test_mnist_trajectory_matches_jax(optimizer, steps, monkeypatch):
    """5 Adam steps and one NatGrad step of the MNIST-shaped model: the
    ELBO and every parameter at rtol 1e-6 with an absolute floor of 1e-7
    of the array's largest magnitude (tests/test_torch_training.py's rule)."""
    monkeypatch.setenv('DEEPCGP_PALLAS_EXTRACT', '1')
    for t, state_j, elbo_j, state, elbo in _trajectory(optimizer, steps):
        np.testing.assert_allclose(elbo, elbo_j, rtol=1e-6, err_msg=f'step {t}')
        for key, p in state.params.items():
            ref = np.asarray(jax_leaf(state_j.model, key))
            p = p.detach()
            if key.endswith('q_sqrt'):
                ref, p = np.tril(ref), torch.tril(p)
            np.testing.assert_allclose(
                p.numpy(), ref, rtol=1e-6,
                atol=1e-7 * np.abs(ref).max() + 1e-12,
                err_msg=f'{optimizer} step {t} {key}')
    assert int(state.step) == steps


def _write_run(root, flags, model, step):
    checkpoint.save_model(os.path.join(root, 'run.npy'), model, step)
    run = os.path.join(root, 'run')
    os.makedirs(run)
    with open(os.path.join(run, 'options.toml'), 'w') as f:
        f.write('name = "run"\n')
        for k in ('M', 'feature_maps', 'filter_sizes', 'strides',
                  'base_kernel', 'last_kernel'):
            f.write(f'{k} = "{getattr(flags, k)}"\n')
        f.write(f'white = false\nidentity_mean = false\n'
                f'num_samples = {flags.num_samples}\n')
    return run


def _round_trip(tmp_path, fused):
    flags, image, _ = GEOMETRIES['mnist']
    rng = np.random.RandomState(11)
    X = rng.randn(64, *image)
    Y = rng.randint(0, 10, size=(64, 1))
    model = build_model(flags, image, images=X,
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.float64, device='cpu')
    assert cuda_cross.fused_fits(model.layers[-1].kernel) == fused
    config = trainer.TrainConfig(batch_size=8)
    state = trainer.init_state(model, config, seed=5)
    Xd = torch.as_tensor(X.reshape(64, -1))
    before = {r: profiling.COUNTERS[f'cross route {r}']
              for r in ('fused', 'unfused')}
    trace = trainer.run_chunk(state, config, Xd, torch.as_tensor(Y), 3)
    assert torch.isfinite(trace).all()
    routes = {r: profiling.COUNTERS[f'cross route {r}'] - n
              for r, n in before.items()}
    taken, other = ('fused', 'unfused') if fused else ('unfused', 'fused')
    assert routes[taken] >= 3 and routes[other] == 0, routes
    run = _write_run(str(tmp_path), flags, model, int(state.step))
    pred = Predictor.from_run_dir(run, image, batch_size=8, num_samples=3,
                                  dtype=torch.float64, device='cpu')
    for (key, p), q in zip(model.named_parameters(), pred.model.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-12, atol=1e-14, err_msg=key)
    probs = pred.predict_proba(X[:13])
    assert probs.shape == (13, 10) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=5e-3)


def test_mnist_train_save_serve_round_trip(tmp_path):
    """A fresh MNIST-shaped ConvKernel model (P = 100) trains on the fused
    route (the row-tiled image side), saves as a reference snapshot, and
    ``Predictor.from_run_dir`` serves it: the same parameters, finite
    probabilities that sum to 1."""
    _round_trip(tmp_path, True)


def test_mnist_train_save_serve_round_trip_unfused(tmp_path, monkeypatch):
    """The same round trip on the unfused route, forced."""
    monkeypatch.setattr(cuda_cross, 'fused_fits', lambda kernel: False)
    _round_trip(tmp_path, False)


@pytest.mark.parametrize('cls', ['conv', 'add'])
def test_unfused_route_matches_fused_at_mnist_geometry(cls):
    """At the MNIST ConvKernel's geometry (28 x 28, f = 5: P = 576, L =
    25), the unfused pair (``_cross`` and ``Kdiag`` off one extraction)
    equals the fused plain route's, values and every gradient (float64,
    1e-10), and each call counts its route once in
    ``profiling.COUNTERS``."""
    tcls = {'conv': ConvKernel, 'add': AdditivePatchKernel}[cls]
    rng = np.random.RandomState(12)
    view = FullView(input_size=(28, 28), filter_size=5, feature_maps=1)
    assert (view.patch_count, view.patch_length) == (576, 25)
    X = torch.tensor(0.5 * rng.randn(3, 28 * 28))
    Z = torch.tensor(0.5 * rng.randn(40, 25))
    cz, cd = torch.tensor(rng.randn(3, 40)), torch.tensor(rng.randn(3))
    outs = []
    for fused in (True, False):
        k = tcls(RBF.create(1.3, 4.0, dtype=torch.float64),
                 torch.tensor(rng.rand(576) + 0.5), view)
        for i, p in enumerate(k.parameters()):
            if outs:
                p.data.copy_(outs[0][2][i])
            p.requires_grad_(True)
        Zi, Xi = Z.clone().requires_grad_(True), X.clone().requires_grad_(True)
        before = dict(profiling.COUNTERS)
        if fused:
            kzx, kd = k.Kzx_NM_and_Kdiag(Zi, Xi)
        else:
            patches = k._patches(Xi)
            kzx, kd = k._cross(Zi, patches), k.Kdiag(Xi, patches)
        counted = {r: profiling.COUNTERS[f'cross route {r}']
                   - before.get(f'cross route {r}', 0)
                   for r in ('fused', 'unfused')}
        assert counted == {'fused': int(fused), 'unfused': 0}
        params = list(k.parameters())
        grads = torch.autograd.grad((kzx * cz).sum() + (kd * cd).sum(),
                                    [Zi, Xi] + params)
        outs.append(([kzx, kd], grads, [p.detach() for p in k.parameters()]))
    for a, b in zip(outs[0][0] + list(outs[0][1]),
                    outs[1][0] + list(outs[1][1])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-10,
                                   atol=1e-10 * float(b.detach().abs().max()))
    k = tcls(RBF.create(1.3, 4.0, dtype=torch.float64),
             torch.tensor(rng.rand(36) + 0.5),
             FullView(input_size=(10, 10), filter_size=5, feature_maps=32))
    before = profiling.COUNTERS['cross route unfused']
    k.Kzx_NM_and_Kdiag(torch.tensor(rng.randn(5, 800)),
                       torch.tensor(rng.randn(2, 3200)))
    assert profiling.COUNTERS['cross route unfused'] == before + 1


def test_ard_patch_last_layer_snapshot_both_ways(tmp_path):
    """A patch last layer with vector lengthscales: the JAX package's
    snapshot loads into the port, the port's snapshot loads into the JAX
    package, and the lengthscales survive both ways unchanged."""
    flags, image, _ = GEOMETRIES['ard']
    model, X, Y = _jax_model('ard')
    ls = np.asarray(model.layers[-1].kernel.base_kernel.lengthscales)
    assert ls.shape == (27,)
    port = port_of(model, flags, image)
    np.testing.assert_allclose(
        port.layers[-1].kernel.base_kernel.lengthscales.numpy(), ls, rtol=1e-12)
    path = os.path.join(str(tmp_path), 'ard.npy')
    checkpoint.save_model(path, port, 3)
    step, loaded = jckpt.parse_layer_parameters(jckpt.load_raw(path), 2)
    assert step == 3
    back = jbuild(flags, X.reshape(-1, *image), Y, jax.random.PRNGKey(0),
                  loaded_parameters=loaded, dtype=np.float64)
    np.testing.assert_allclose(
        np.asarray(back.layers[-1].kernel.base_kernel.lengthscales), ls,
        rtol=1e-12)
    np.testing.assert_allclose(np.asarray(back.layers[-1].kernel.patch_weights),
                               np.asarray(model.layers[-1].kernel.patch_weights),
                               rtol=1e-12)


@pytest.mark.parametrize('cls', ['conv', 'add'])
def test_kdiag_with_an_arccosine_base_matches_jax(cls, monkeypatch):
    """Kdiag of both patch-sum kernels over an ArcCosine base reads the
    patches (an RBF base's is the constant variance * mean(w)): alone and
    through ``Kzx_NM_and_Kdiag``, whose extraction it shares, against the
    JAX package on its Pallas extraction, float64, random weights."""
    from deepcgp_tpu.models.base_kernels import ArcCosine as JArcCosine
    from deepcgp_tpu.models.conv_kernels import (AdditivePatchKernel as JAdd,
                                                 ConvKernel as JConv)
    from deepcgp_tpu.models.views import FullView as JFullView
    from deepcgp_tpu_torch.models.base_kernels import ArcCosine
    monkeypatch.setenv('DEEPCGP_PALLAS_EXTRACT', '1')
    jcls, tcls = {'conv': (JConv, ConvKernel),
                  'add': (JAdd, AdditivePatchKernel)}[cls]
    rng = np.random.RandomState(11)
    geometry = dict(input_size=(9, 11), filter_size=3, feature_maps=2,
                    stride=2, dilation=2)
    jview = JFullView(**geometry)
    jbase = JArcCosine.create(variance=1.3, weight_variances=0.5 + rng.rand(18),
                              bias_variance=0.7, order=1, dtype=jnp.float64)
    w = rng.rand(jview.patch_count) + 0.5
    jk = jcls.create(jbase, jview, patch_weights=jnp.asarray(w),
                     dtype=jnp.float64)
    assert jk._pallas_order() and jk._kdiag_needs_patches()
    tk = tcls(ArcCosine(*(torch.tensor(np.asarray(getattr(jbase, f'raw_{n}')))
                          for n in ('variance', 'weight_variances',
                                    'bias_variance')), order=1),
              torch.tensor(w), FullView(**geometry))
    assert tk._kdiag_needs_patches() and not cuda_cross.fused_fits(tk)
    X = rng.randn(5, 9 * 11 * 2)
    Z = rng.randn(4, 18)
    kd = jk.Kdiag(jnp.asarray(X))
    kzx_j, kd_j = jk.Kzx_NM_and_Kdiag(jnp.asarray(Z), jnp.asarray(X))
    kzx, kd_shared = tk.Kzx_NM_and_Kdiag(torch.tensor(Z), torch.tensor(X))
    for a, b in ((tk.Kdiag(torch.tensor(X)), kd), (kd_shared, kd_j),
                 (kzx, kzx_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-13)
    # Not the RBF's constant: the patches enter.
    assert float(np.ptp(np.asarray(kd))) > 1e-3
