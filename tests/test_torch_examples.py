"""The port's example scripts (deepcgp_tpu_torch/examples) against the JAX
package's ``examples/*.py`` on the CPU.  Each JAX script runs under
``runpy`` as ``__main__`` with its entry point (``deepcgp_tpu.mnist.main``,
``read_args`` and the experiment class) patched to record the argv it is
given: ``train_mnist.ARGV``, ``fm_sweep``'s per-point flags and each
parity mode's flags equal the JAX script's.  Both parity scripts return 2
without their ``.npz``, and their messages and exit codes follow the JAX
scripts'.  ``serve.main`` on a tiny run dir written by the JAX CLI prints
the accuracy and density the port's Predictor gives, and
``inspect_model.main`` writes the JAX script's files, its
``inducing_grid.npy`` equal to the JAX package's grid of the same run."""

import csv
import io
import os
import pathlib
import runpy
import sys
import types
from contextlib import redirect_stderr, redirect_stdout

import jax
import numpy as np
import pytest

import deepcgp_tpu.cifar as jcifar
import deepcgp_tpu.mnist as jmnist
from deepcgp_tpu.serving import Predictor as JPredictor
from deepcgp_tpu.training import data as jdata
from deepcgp_tpu.utils import inspect as jinspect

from deepcgp_tpu_torch.examples import (cifar_parity, fm_sweep, inspect_model,
                                        mnist_parity, serve, train_mnist)
from deepcgp_tpu_torch.serving import Predictor
from deepcgp_tpu_torch.training import data

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_EXAMPLES = ROOT / 'examples'


class FakeExperiment:
    """Stands in for an Experiment: records nothing, trains nothing."""
    accuracy = 0.99

    def __init__(self, flags, device=None):
        self.flags = flags
        self.last_mean_elbo = -1.5
        self.chunks = 0

    def train_step(self):
        self.chunks += 1

    def run(self):
        self.train_step()

    def conclude(self):
        pass

    def test_accuracy(self):
        return self.accuracy


def _recording(module, monkeypatch, experiment='MNIST'):
    """Patch ``module.read_args`` to record its argv and the experiment
    class with ``FakeExperiment``; returns the list of recorded argvs."""
    seen = []

    def read_args(argv=None):
        seen.append(list(argv))
        return types.SimpleNamespace(argv=list(argv))
    monkeypatch.setattr(module, 'read_args', read_args)
    monkeypatch.setattr(module, experiment, FakeExperiment)
    return seen


def _run_jax_script(name, argv, monkeypatch):
    """Run examples/<name>.py as __main__ with ``argv``; returns (exit
    code, stdout, stderr)."""
    monkeypatch.setattr(sys, 'argv', [str(JAX_EXAMPLES / name), *argv])
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with redirect_stdout(out), redirect_stderr(err):
        try:
            runpy.run_path(str(JAX_EXAMPLES / name), run_name='__main__')
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


def _call(fn, *a, **k):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = fn(*a, **k)
    return code, out.getvalue(), err.getvalue()


def test_train_mnist_argv_equals_jax(monkeypatch):
    seen = []
    monkeypatch.setattr(jmnist, 'main', lambda argv=None: seen.append(argv))
    _run_jax_script('train_mnist.py', [], monkeypatch)
    assert seen == [train_mnist.ARGV]
    from deepcgp_tpu_torch import mnist
    calls = []
    monkeypatch.setattr(mnist, 'main',
                        lambda argv=None, device=None: calls.append((argv, device)))
    train_mnist.main(device='cpu')
    assert calls == [(train_mnist.ARGV, 'cpu')]


def test_fm_sweep_flags_and_summary_equal_jax(monkeypatch, tmp_path):
    args = ['--feature-maps', '1', '2', '--chunks', '3', '--test-every', '7']
    jseen = _recording(jcifar, monkeypatch, 'Cifar')
    _run_jax_script('fm_sweep.py', args + ['--log-dir', str(tmp_path / 'j')],
                    monkeypatch)
    seen = _recording(fm_sweep, monkeypatch, 'Cifar')
    rows = fm_sweep.main(args + ['--log-dir', str(tmp_path / 'j')],
                         device='cpu')
    assert seen == jseen and len(seen) == 2
    assert seen[0] == fm_sweep.point_argv(1, 7, 3, str(tmp_path / 'j'))
    assert '--no-tensorboard' in seen[1]
    with open(tmp_path / 'j' / 'fm_sweep_summary.csv') as f:
        assert list(csv.reader(f)) == [
            ['feature_maps', 'test_accuracy', 'train_elbo'],
            ['1', '0.99', '-1.5'], ['2', '0.99', '-1.5']]
    assert [r['feature_maps'] for r in rows] == [1, 2]


MNIST_MODES = [[], ['--m1024'], ['--fast'], ['--fast', '--threshold', '0.999'],
               ['--m1024', '--fast']]


@pytest.mark.parametrize('mode', MNIST_MODES, ids=' '.join)
def test_mnist_parity_flags_and_outcome_equal_jax(mode, monkeypatch, tmp_path):
    monkeypatch.setenv('DEEPCGP_DATA_DIR', str(tmp_path))
    (tmp_path / 'mnist.npz').write_bytes(b'')   # only its presence is read
    log = ['--log-dir', str(tmp_path / 'logs')]
    jseen = _recording(jmnist, monkeypatch)
    jcode, jout, jerr = _run_jax_script('mnist_parity.py', mode + log,
                                        monkeypatch)
    seen = _recording(mnist_parity, monkeypatch)
    code, out, err = _call(mnist_parity.main, mode + log, device='cpu')
    assert (code, out, err) == (jcode, jout, jerr)
    assert seen == jseen
    if code != 2:
        assert seen == [mnist_parity.parity_argv(str(tmp_path / 'logs'),
                                                 '--m1024' in mode,
                                                 '--fast' in mode)]


@pytest.mark.parametrize('mode', [[], ['--threshold', '0.9999']], ids=' '.join)
def test_cifar_parity_flags_and_outcome_equal_jax(mode, monkeypatch, tmp_path):
    monkeypatch.setenv('DEEPCGP_DATA_DIR', str(tmp_path))
    (tmp_path / 'cifar10.npz').write_bytes(b'')
    log = ['--log-dir', str(tmp_path / 'logs')]
    jseen = _recording(jcifar, monkeypatch, 'Cifar')
    jcode, jout, jerr = _run_jax_script('cifar_parity.py', mode + log,
                                        monkeypatch)
    seen = _recording(cifar_parity, monkeypatch, 'Cifar')
    code, out, err = _call(cifar_parity.main, mode + log, device='cpu')
    assert (code, out, err) == (jcode, jout, jerr)
    assert seen == jseen == [cifar_parity.parity_argv(str(tmp_path / 'logs'))]


@pytest.mark.parametrize('script', ['mnist_parity', 'cifar_parity'])
def test_parity_refuses_without_data(script, monkeypatch, tmp_path):
    """Return 2 and build no experiment, as the JAX script does."""
    monkeypatch.setenv('DEEPCGP_DATA_DIR', str(tmp_path))
    module = {'mnist_parity': mnist_parity, 'cifar_parity': cifar_parity}[script]
    seen = _recording(module, monkeypatch,
                      'MNIST' if script == 'mnist_parity' else 'Cifar')
    code, out, err = _call(module.main, [], device='cpu')
    jcode, jout, jerr = _run_jax_script(f'{script}.py', [], monkeypatch)
    assert code == jcode == 2 and seen == []
    assert (out, err) == (jout, jerr) and 'not found' in err


TINY = ['-N', '64', '-M', '4,4', '--feature-maps', '2', '--filter-sizes',
        '5,5', '--strides', '2,2', '--test-every', '2', '--lr-decay-steps',
        '4', '--test-size', '32', '--num-samples', '2', '--batch-size', '8',
        '--no-tensorboard']


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """A two-chunk run of the JAX MNIST CLI on the synthetic fallback:
    its run dir."""
    root = tmp_path_factory.mktemp('jax')
    empty = tmp_path_factory.mktemp('none')
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEEPCGP_DATA_DIR', str(empty))
        exp = jmnist.MNIST(jmnist.read_args(['--name', 'mnist_example', *TINY,
                                             '--log-dir', str(root)]))
        try:
            exp.train_step()
            exp.train_step()
        finally:
            exp.conclude()
    return root / 'mnist_example', empty


def test_serve_prints_the_predictors_numbers(jax_run, monkeypatch):
    run_dir, empty = jax_run
    monkeypatch.setenv('DEEPCGP_DATA_DIR', str(empty))
    (acc, dens), out, _ = _call(serve.main, str(run_dir), device='cpu')
    X_train, _, X_test, Y_test = data.mnist_data(
        types.SimpleNamespace(N=2000, test_size=1000, seed=0))
    pred = Predictor.from_run_dir(str(run_dir), X_train.shape[1:],
                                  batch_size=128, num_samples=5, device='cpu')
    pred.predict_proba(X_test[:128])
    want_acc = float((pred.predict(X_test)[:, None] == Y_test).mean())
    want_dens = float(np.mean(pred.log_density(X_test[:32], Y_test[:32])))
    assert (acc, dens) == (want_acc, want_dens)
    lines = out.splitlines()
    assert lines[0].startswith('served 1000 points in ')
    assert lines[0].endswith(f'img/s), accuracy {want_acc:.4f}')
    assert lines[1] == f'mean predictive log-density (first 32): {want_dens}'


def test_inspect_model_writes_the_jax_files(jax_run, monkeypatch):
    run_dir, empty = jax_run
    monkeypatch.setenv('DEEPCGP_DATA_DIR', str(empty))
    written, out, _ = _call(inspect_model.main, str(run_dir), device='cpu')
    names = [os.path.basename(p) for p in written]
    assert names == ['inducing_grid.npy', 'embedding_inducing.npy',
                     'embedding_data.npy', 'inducing_grid_layer0.png',
                     'patch_embedding_layer0.png', 'inducing_grid_layer1.png',
                     'noise_robustness.png']
    flags = types.SimpleNamespace(N=2000, test_size=1000, seed=0)
    X_train, Y_train, _, _ = jdata.mnist_data(flags)
    jmodel = JPredictor.from_run_dir(str(run_dir), X_train, Y_train).model
    np.testing.assert_array_equal(np.load(run_dir / 'inducing_grid.npy'),
                                  jinspect.inducing_patch_grid(jmodel.layers[0]))
    emb_z = np.load(run_dir / 'embedding_inducing.npy')
    assert emb_z.shape == (4, 2)
    assert np.load(run_dir / 'embedding_data.npy').shape == (2000, 2)
    lines = out.splitlines()
    assert lines[0].startswith('layer output shapes: [(1, 256, ')
    assert [ln.split(':')[0] for ln in lines[2:6]] == [
        f'noise sigma={s:.2f}' for s in (0.0, 0.25, 0.5, 1.0)]
    assert jax.devices()[0].platform == 'cpu'
