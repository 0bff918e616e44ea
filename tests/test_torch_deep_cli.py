"""The port's CLI with ``--base-kernel acos``, ``--identity-mean`` and
three-entry ``-M``/``--filter-sizes``/``--strides`` on the CPU, on the
synthetic CIFAR fallback: ``options.toml`` byte for byte as the JAX CLI
writes it, a run stopped and resumed from its full-state snapshot bit-equal
to an unbroken one (the identity mean's filter travels in the state dict),
and the run served from its run dir by ``Predictor.from_run_dir``."""

import csv
import os

import numpy as np
import pytest
import torch

from deepcgp_tpu import cifar as jcifar

from deepcgp_tpu_torch import cifar
from deepcgp_tpu_torch.serving import Predictor

from test_torch_experiment import _state_tensors

DEEP = ['-N', '48', '-M', '8,8,8', '--feature-maps', '2,2', '--filter-sizes',
        '5,3,3', '--strides', '2,1,1', '--identity-mean', '--base-kernel',
        'acos', '--test-every', '2', '--lr-decay-steps', '4', '--test-size',
        '16', '--num-samples', '2', '--batch-size', '8', '--no-tensorboard']
IMAGE = (32, 32, 3)


@pytest.fixture(autouse=True)
def _no_dataset(monkeypatch, tmp_path_factory):
    """The synthetic fallback, whatever lies in the user's data dir."""
    monkeypatch.setenv('DEEPCGP_DATA_DIR', str(tmp_path_factory.mktemp('none')))


def _rows(path):
    with open(path) as f:
        return [r for r in csv.DictReader(f) if r['Entry'] != 'Entry']


def test_options_toml_byte_equal_to_jax(tmp_path, monkeypatch):
    """Each CLI builds the 3-layer acos + identity-mean model from the same
    argv (the same relative --log-dir) and writes the same bytes."""
    argv = ['--name', 'deep', *DEEP, '--log-dir', 'results']
    written = {}
    for side, entry, kw in (('jax', jcifar, {}), ('port', cifar,
                                                  {'device': 'cpu'})):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        exp = entry.Cifar(entry.read_args(argv), **kw)
        exp.conclude()
        assert len(exp.model.layers) == 3
        written[side] = (tmp_path / side / 'results' / 'deep' /
                         'options.toml').read_bytes()
    assert b'identity_mean = true' in written['port']
    assert b'base_kernel = "acos"' in written['port']
    assert written['port'] == written['jax']


@pytest.mark.parametrize('optimizer', ['Adam', 'NatGrad'])
def test_resume_equals_an_unbroken_run_and_serves(optimizer, tmp_path,
                                                  monkeypatch):
    """Stopped after one chunk and resumed with --full-state-ckpt, the
    3-layer run ends bit-equal to an unbroken one: parameters, buffers
    (each hidden layer's Z0 and delta filter), moments, count, generator
    and NatGrad's state, and the train_elbo and test_accuracy columns.
    Its snapshot, served from the run dir, predicts what the trained model
    predicts on the same noise."""
    monkeypatch.chdir(tmp_path)
    extra = ['--optimizer', optimizer, '--full-state-ckpt']
    if optimizer == 'NatGrad':
        extra += ['--natgrad-warm-steps', '2']

    def start(root):
        argv = ['--name', 'r', *DEEP, '--log-dir', root, *extra]
        return cifar.Cifar(cifar.read_args(argv), device='cpu')
    whole = start('whole')
    whole.run()
    assert whole.global_step == 10
    first = start('cut')
    first.train_step()
    first.conclude()
    resumed = start('cut')
    assert resumed.global_step == 2
    resumed.run()
    a, b = _state_tensors(whole.state), _state_tensors(resumed.state)
    assert 'buffer/layers.1.mean_function.conv_filter' in a
    for k in a:
        assert torch.equal(a[k], b[k]), k
    want, got = _rows('whole/r/log.csv'), _rows('cut/r/log.csv')
    assert len(want) == len(got) == 5
    for col in ('global_step', 'test_accuracy', 'train_elbo'):
        assert [r[col] for r in want] == [r[col] for r in got], col
    assert all(np.isfinite(float(r['train_elbo'])) for r in got)

    pred = Predictor.from_run_dir('whole/r', IMAGE, batch_size=8,
                                  num_samples=2, device='cpu')
    X = torch.as_tensor(whole.X_test[:8].reshape(8, -1))
    rng = np.random.RandomState(0)
    noise = [rng.randn(2, 8, layer.num_outputs) for layer in whole.model.layers]
    served = pred.model.predict_y(X, 2, noise=noise)[0]
    trained = whole.model.predict_y(X, 2, noise=noise)[0]
    np.testing.assert_allclose(served.numpy(), trained.numpy(), rtol=1e-6,
                               atol=1e-7)
