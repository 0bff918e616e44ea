"""The PyTorch port's CLI against the JAX package's on the CPU, on one tiny
MNIST run of each (two chunks, the same argv): ``options.toml`` keys,
values and types, the ``log.csv`` header and its ``global_step`` and
``lr`` columns, each package's ``Predictor.from_run_dir`` serving the
other's run directory, and ``--load-model`` of a JAX-written snapshot,
which gives the port's Experiment the JAX Experiment's parameters and, on a
fixed batch with JAX's Monte-Carlo noise replayed, its ELBO (1e-9 relative
in float64, 1e-5 in float32)."""

import copy
import csv
import os
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu import mnist as jmnist
from deepcgp_tpu.serving import Predictor as JPredictor
from deepcgp_tpu.training import optim as joptim
from deepcgp_tpu.utils import checkpoint as jckpt

from deepcgp_tpu_torch import mnist
from deepcgp_tpu_torch.serving import Predictor
from deepcgp_tpu_torch.utils import checkpoint

from test_torch_training import jax_draws

TINY = ['-N', '64', '-M', '4,4', '--feature-maps', '2', '--filter-sizes',
        '5,5', '--strides', '2,2', '--test-every', '2', '--lr-decay-steps',
        '4', '--test-size', '32', '--num-samples', '2', '--batch-size', '8',
        '--no-tensorboard']
IMAGE = (28, 28, 1)


def _two_chunks(exp):
    try:
        exp.train_step()
        exp.train_step()
    finally:
        exp.conclude()
    return exp


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """One two-chunk run of each CLI on the synthetic fallback, each in a
    log dir of its own: {'jax': (dir, experiment), 'port': (...)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEEPCGP_DATA_DIR', str(tmp_path_factory.mktemp('none')))
        for side, entry, kw in (('jax', jmnist, {}),
                                ('port', mnist, {'device': 'cpu'})):
            root = tmp_path_factory.mktemp(side)
            argv = ['--name', 'run', *TINY, '--log-dir', str(root)]
            out[side] = (root, _two_chunks(entry.MNIST(entry.read_args(argv),
                                                       **kw)))
    return out


def _toml(root):
    with open(os.path.join(root, 'run', 'options.toml'), 'rb') as f:
        return tomllib.load(f)


def _csv(root):
    with open(os.path.join(root, 'run', 'log.csv')) as f:
        return list(csv.reader(f))


def test_options_toml_equals_jax(runs):
    ours, want = _toml(runs['port'][0]), _toml(runs['jax'][0])
    assert list(ours) == list(want)
    for k, v in want.items():
        assert type(ours[k]) is type(v), k
        if k != 'log_dir':
            assert ours[k] == v, k
    assert 'preprocessing' not in ours


def test_log_csv_columns_equal_jax(runs):
    """The same header, and the same global_step and lr at each entry."""
    ours, want = _csv(runs['port'][0]), _csv(runs['jax'][0])
    assert ours[0] == want[0] == ['Entry', 'global_step', 'lr', 'test_accuracy',
                                  'train_elbo', 'steps_per_sec']
    assert len(ours) == len(want) == 3
    for a, b in zip(ours[1:], want[1:]):
        assert a[:3] == b[:3]
    exp, jexp = runs['port'][1], runs['jax'][1]
    assert exp.global_step == jexp.global_step == 4
    assert exp.learning_rate == jexp.learning_rate


@pytest.mark.parametrize('staircase', [True, False])
def test_learning_rate_equals_jax(staircase, runs):
    exp = copy.copy(runs['port'][1])
    exp.config = copy.copy(exp.config)
    object.__setattr__(exp.config, 'lr_staircase', staircase)
    ref = joptim.learning_rate_schedule(0.01, 4, staircase=staircase)
    step_dtype = runs['jax'][1].state.step.dtype      # as the JAX CLI calls it
    for step in (0, 1, 2, 3, 4, 6, 8, 9, 12, 40):
        exp.state = copy.copy(exp.state)
        exp.state.step = torch.tensor(step)
        assert exp.learning_rate == float(ref(jnp.asarray(step, step_dtype))), step
        assert exp.global_step == step


def _noise_probs(jmodel, model, X):
    key = jax.random.PRNGKey(5)
    noise = jax_draws(jmodel, key, X.shape[0])
    pj, _ = jax.jit(lambda m, x: m.predict_y(x, key, m.num_samples))(
        jmodel, jnp.asarray(X))
    p, _ = model.predict_y(torch.as_tensor(X), jmodel.num_samples, noise=noise)
    return np.asarray(pj), p.detach().numpy()


def test_port_predictor_serves_the_jax_run(runs):
    root, jexp = runs['jax']
    pred = Predictor.from_run_dir(str(root / 'run'), IMAGE, batch_size=8,
                                  num_samples=2, device='cpu')
    with np.load(root / 'run' / 'preprocessing.npz') as d:
        np.testing.assert_array_equal(pred.preprocessing['mean'], d['mean'])
    want = jckpt.model_parameters(jexp.state.model, 4)
    got = checkpoint.model_parameters(pred.model, 4)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    raw = np.random.RandomState(0).rand(10, 784) * 255.0
    probs = pred.predict_proba(raw, raw=True)
    assert probs.shape == (10, 10) and np.isfinite(probs).all()
    X = pred._prepare(raw, raw=True)
    pj, p = _noise_probs(jexp.state.model, pred.model, X)
    np.testing.assert_allclose(p, pj, rtol=1e-5, atol=1e-6)


def test_jax_predictor_serves_the_port_run(runs):
    root, exp = runs['port']
    X = exp.X_train[:16].reshape(16, -1)
    pred = JPredictor.from_run_dir(str(root / 'run'), exp.X_train[:16],
                                   exp.Y_train[:16], batch_size=8,
                                   num_samples=2)
    with np.load(root / 'run' / 'preprocessing.npz') as d:
        np.testing.assert_array_equal(pred.preprocessing['scale'], d['scale'])
    want = checkpoint.model_parameters(exp.model, 4)
    got = jckpt.model_parameters(pred.model, 4)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    raw = np.random.RandomState(1).rand(10, 784) * 255.0
    probs = pred.predict_proba(raw, raw=True)
    assert probs.shape == (10, 10) and np.isfinite(probs).all()
    pj, p = _noise_probs(pred.model, exp.model, X)
    np.testing.assert_allclose(p, pj, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope='module')
def loaded(runs, tmp_path_factory):
    """--load-model of the JAX run's snapshot, into a JAX and a port
    Experiment (no training)."""
    root = runs['jax'][0]
    argv = ['--name', 'lm', *TINY, '--log-dir', str(root),
            '--load-model', 'run']
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEEPCGP_DATA_DIR', str(tmp_path_factory.mktemp('none')))
        jexp = jmnist.MNIST(jmnist.read_args(argv))
        exp = mnist.MNIST(mnist.read_args(argv), device='cpu')
    jexp.conclude()
    exp.conclude()
    return jexp, exp


def test_load_model_gives_the_jax_parameters(loaded, runs):
    jexp, exp = loaded
    assert exp.global_step == jexp.global_step == 4
    assert exp.initial_step == 4
    want = jckpt.model_parameters(jexp.state.model, 4)
    got = checkpoint.model_parameters(exp.model, 4)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    # The KL anchor restarts at the loaded Z, as in JAX.
    np.testing.assert_array_equal(exp.model.layers[0].Z0.numpy(),
                                  np.asarray(jexp.state.model.layers[0].Z0))
    assert exp.model.num_data == jexp.state.model.num_data == 64
    # The snapshot the JAX run wrote is the one both read.
    raw = checkpoint.load_raw(str(runs['jax'][0] / 'run.npy'))
    np.testing.assert_array_equal(raw['DGP/layers/1/q_mu'],
                                  exp.model.layers[1].q_mu.detach().numpy())


@pytest.mark.parametrize('dtype,rtol', [(np.float64, 1e-9), (np.float32, 1e-5)],
                         ids=['f64', 'f32'])
def test_load_model_elbo_equals_jax(loaded, dtype, rtol):
    jexp, exp = loaded
    jmodel = jax.tree_util.tree_map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating)
        else a, jexp.state.model)
    model = copy.deepcopy(exp.model).to(torch.float64 if dtype == np.float64
                                        else torch.float32)
    X = exp.X_train[:16].reshape(16, -1).astype(dtype)
    Y = exp.Y_train[:16]
    key = jax.random.PRNGKey(11)
    elbo_j = float(jax.jit(lambda m, x, y: m.elbo(x, y, key))(
        jmodel, jnp.asarray(X), jnp.asarray(Y)))
    with torch.no_grad():
        elbo = model.elbo(torch.as_tensor(X), torch.as_tensor(Y),
                          noise=jax_draws(jmodel, key, 16))
    assert elbo.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    np.testing.assert_allclose(float(elbo), elbo_j, rtol=rtol)
