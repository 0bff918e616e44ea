"""The PyTorch port's Experiment layer and CLI on the CPU
(``deepcgp_tpu_torch/training/experiment.py`` and the ``cifar``, ``mnist``
and ``digits`` entry points, ``device='cpu'``): the run's files, a run
stopped and resumed from its full-state snapshot against an unbroken one
(bit for bit, Adam and NatGrad), the snapshot retention, the NatGrad warm
start, the refused options, the card default and the digits entry point.
The comparisons with the JAX package's CLI are in
``test_torch_experiment_parity.py``."""

import csv
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepcgp_tpu_torch import cifar, digits, mnist
from deepcgp_tpu_torch.training import arguments, experiment, optim, trainer
from deepcgp_tpu_torch.utils import checkpoint

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ['-N', '64', '-M', '4,4', '--feature-maps', '2', '--filter-sizes',
        '5,5', '--strides', '2,2', '--test-every', '2', '--lr-decay-steps',
        '4', '--test-size', '32', '--num-samples', '2', '--batch-size', '8',
        '--no-tensorboard']


@pytest.fixture(autouse=True)
def _no_dataset(monkeypatch, tmp_path_factory):
    """The synthetic fallback, whatever lies in the user's data dir."""
    monkeypatch.setenv('DEEPCGP_DATA_DIR', str(tmp_path_factory.mktemp('none')))


def _argv(root, name='e2e', *extra):
    return ['--name', name, *TINY, '--log-dir', str(root), *extra]


def _rows(path):
    with open(path) as f:
        return [r for r in csv.DictReader(f) if r['Entry'] != 'Entry']


def test_lifecycle_writes_the_run_files(tmp_path):
    exp = mnist.MNIST(mnist.read_args(_argv(tmp_path)), device='cpu')
    try:
        assert exp.device.type == 'cpu' and exp.X_test_dev.shape == (32, 784)
        exp.train_step()
        exp.train_step()
    finally:
        exp.conclude()
    run = tmp_path / 'e2e'
    lines = (run / 'log.csv').read_text().splitlines()
    assert lines[0] == 'Entry,global_step,lr,test_accuracy,train_elbo,steps_per_sec'
    rows = _rows(run / 'log.csv')
    assert [r['global_step'] for r in rows] == ['2', '4'] and len(lines) == 3
    np.testing.assert_allclose([float(r['lr']) for r in rows], [0.01, 0.001],
                               rtol=1e-7)      # float32, as the JAX CLI's
    assert all(np.isfinite(float(r['train_elbo'])) for r in rows)
    assert all(0.0 <= float(r['test_accuracy']) <= 1.0 for r in rows)
    assert os.path.exists(tmp_path / 'e2e.npy')
    with np.load(run / 'preprocessing.npz') as d:
        assert d['mean'].shape == d['scale'].shape == (784,)
    assert 'name = "e2e"' in (run / 'options.toml').read_text()
    assert not (tmp_path / 'e2e_state').exists()   # no --full-state-ckpt
    # The snapshot holds the trained model at its step.
    raw = checkpoint.load_raw(str(tmp_path / 'e2e.npy'))
    assert raw['global_step'] == 4
    np.testing.assert_array_equal(raw['DGP/layers/1/q_mu'],
                                  exp.model.layers[1].q_mu.detach().numpy())


def _state_tensors(state):
    out = {f'param/{k}': p.detach().clone() for k, p in state.params.items()}
    out.update({f'buffer/{k}': b.clone()
                for k, b in state.model.named_buffers()})
    for moment in ('mu', 'nu'):
        out.update({f'{moment}/{k}': v.clone()
                    for k, v in state.opt_state[moment].items()})
    out['count'] = state.opt_state['count'].clone()
    out['step'] = state.step.clone()
    out['generator'] = state.generator.get_state()
    if state.steps_back is not None:
        out['steps_back'] = state.steps_back.clone()
        out.update({f'prev/{k}': v.clone() for k, v in state.prev.items()})
    return out


@pytest.mark.parametrize('optimizer', ['Adam', 'NatGrad'])
def test_resume_equals_an_unbroken_run(optimizer, tmp_path, monkeypatch):
    """Stopped after one chunk and resumed with --full-state-ckpt, a run ends
    bit-equal to an unbroken one: parameters, buffers, moments (the q_sqrt
    stacks in bf16: the store's threshold is lowered to this model's
    size), count, generator, NatGrad's steps_back and prev, and the
    train_elbo and test_accuracy columns.  The resumed run executes only
    the rest of the schedule."""
    monkeypatch.setattr(optim, 'AUTO_BF16_MIN_ELEMENTS', 32)
    argv = ['--optimizer', optimizer, '--full-state-ckpt']

    def start(root):
        exp = mnist.MNIST(mnist.read_args(_argv(root, 'r', *argv)),
                          device='cpu')
        if optimizer == 'NatGrad':
            # As after one backoff, so that the counter's restore shows.
            exp.state.steps_back.fill_(1.0)
        return exp
    whole = start(tmp_path / 'whole')
    whole.run()
    total = arguments.train_steps(whole.flags) * whole.flags.test_every
    assert total == 10 and whole.global_step == total

    first = start(tmp_path / 'cut')
    if optimizer == 'Adam':
        assert first.state.opt_state['mu']['layers.0.q_sqrt'].dtype == torch.bfloat16
    first.train_step()
    first.conclude()
    saved = _state_tensors(first.state)
    resumed = mnist.MNIST(mnist.read_args(_argv(tmp_path / 'cut', 'r', *argv)),
                          device='cpu')
    assert resumed.global_step == 2
    got = _state_tensors(resumed.state)
    assert got.keys() == saved.keys()
    for k in saved:
        assert saved[k].dtype == got[k].dtype and torch.equal(saved[k], got[k]), k
    resumed.run()
    assert resumed.global_step == total

    a, b = _state_tensors(whole.state), _state_tensors(resumed.state)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    want = _rows(tmp_path / 'whole' / 'r' / 'log.csv')
    got_rows = _rows(tmp_path / 'cut' / 'r' / 'log.csv')
    assert len(want) == len(got_rows) == 5
    for col in ('global_step', 'lr', 'test_accuracy', 'train_elbo'):
        assert [r[col] for r in want] == [r[col] for r in got_rows], col
    # keep=3: the three newest snapshots stay.
    assert sorted(os.listdir(tmp_path / 'whole' / 'r_state')) == [
        'state_10.pt', 'state_6.pt', 'state_8.pt']


def test_state_snapshots_skip_temporary_files(tmp_path):
    d = tmp_path / 'states'
    assert checkpoint.latest_train_state_step(str(d)) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_train_state(str(d), None)
    exp = mnist.MNIST(mnist.read_args(_argv(tmp_path, 'k')), device='cpu')
    exp.conclude()
    for step in (3, 1, 7, 5):
        exp.state.step.fill_(step)
        checkpoint.save_train_state(str(d), exp.state, keep=2)
    assert sorted(os.listdir(d)) == ['state_5.pt', 'state_7.pt']
    (d / 'state_9.pt.tmp-123').write_bytes(b'partial')
    (d / 'notes.txt').write_text('x')
    assert checkpoint.latest_train_state_step(str(d)) == 7
    exp.state.step.fill_(0)
    checkpoint.restore_train_state(str(d), exp.state)
    assert exp.global_step == 7
    # A state of another optimizer is refused.
    ng = trainer.init_state(exp.model, trainer.TrainConfig(optimizer='NatGrad'))
    with pytest.raises(ValueError):
        checkpoint.restore_train_state(str(d), ng)


def test_natgrad_warm_start(tmp_path):
    """--natgrad-warm-steps 2 trains the model with Adam first: the step
    stays 0, the state is NatGrad's (every parameter in it) and the model
    differs from the cold build's."""
    ng = ['--optimizer', 'NatGrad']
    cold = mnist.MNIST(mnist.read_args(_argv(tmp_path, 'cold', *ng)),
                       device='cpu')
    cold.conclude()
    warm = mnist.MNIST(mnist.read_args(
        _argv(tmp_path, 'warm', *ng, '--natgrad-warm-steps', '2')), device='cpu')
    try:
        assert warm.global_step == 0
        assert warm.state.steps_back is not None and warm.state.prev is not None
        assert set(warm.state.params) == set(dict(warm.model.named_parameters()))
        assert all(p.requires_grad for p in warm.model.parameters())
        assert int(warm.state.opt_state['count']) == 0
        for k, p in cold.model.named_parameters():
            assert torch.equal(warm.state.prev[k], dict(
                warm.model.named_parameters())[k].detach()), k
        assert not torch.equal(cold.model.layers[0].q_mu,
                               warm.model.layers[0].q_mu)
        assert not torch.equal(cold.model.layers[1].Z, warm.model.layers[1].Z)
        warm.train_step()
        assert np.isfinite(warm.last_mean_elbo) and warm.global_step == 2
    finally:
        warm.conclude()


@pytest.mark.parametrize('extra,match', [
    (['--mesh', 'data=2'], 'needs 2 ranks, the world has 1'),
    (['--distributed'], 'RANK expected')], ids=['mesh', 'distributed'])
def test_multi_device_options_raise(extra, match, tmp_path, monkeypatch):
    """In one process without a process group, a mesh larger than the
    world raises, and ``--distributed`` without its environment lets the
    failed ``init_process_group`` propagate; neither writes anything.
    (The multi-process runs are in test_torch_parallel_cli.py.)"""
    for var in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT',
                'LOCAL_RANK'):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=match):
        mnist.MNIST(mnist.read_args(_argv(tmp_path, 'm', *extra)), device='cpu')
    assert not (tmp_path / 'm').exists()


def test_unknown_optimizer_raises(tmp_path):
    with pytest.raises(ValueError, match='optimizer'):
        mnist.MNIST(mnist.read_args(_argv(tmp_path, 'o', '--optimizer', 'Lion')),
                    device='cpu')


@pytest.mark.parametrize('entry', [cifar, mnist, digits],
                         ids=['cifar', 'mnist', 'digits'])
def test_main_needs_a_device(entry, monkeypatch, tmp_path):
    """Without device=, an entry point runs on the card, and raises where
    there is none, before it loads anything."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        entry.main(['--name', 'n', '--log-dir', str(tmp_path)])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize('name', ['cifar', 'mnist', 'digits'])
def test_module_runs_as_a_program(name, tmp_path):
    """``python -m deepcgp_tpu_torch.<name>`` parses the CLI and, on a
    machine without a card, stops before it loads anything."""
    env = {**os.environ, 'CUDA_VISIBLE_DEVICES': ''}
    out = subprocess.run(
        [sys.executable, '-m', f'deepcgp_tpu_torch.{name}', '--name', 'n',
         '--log-dir', str(tmp_path)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0 and 'CUDA is not available' in out.stderr
    assert os.listdir(tmp_path) == []


def test_digits_entry_point_runs_two_chunks(tmp_path):
    exp = digits.main(['--name', 'dg', '-N', '256', '-M', '8', '--test-every',
                       '5', '--lr-decay-steps', '4', '--test-size', '64',
                       '--num-samples', '2', '--batch-size', '16',
                       '--log-dir', str(tmp_path), '--no-tensorboard'],
                      device='cpu')
    rows = _rows(tmp_path / 'dg' / 'log.csv')
    assert [r['global_step'] for r in rows] == ['5', '10']
    assert exp.global_step == 10 and exp.X_train.shape == (256, 8, 8, 1)
    assert exp.X_test_dev.shape == (64, 64)
    assert all(np.isfinite(float(r['train_elbo'])) for r in rows)
    assert os.path.exists(tmp_path / 'dg.npy')


def test_eval_seed_fresh_per_step():
    assert experiment.eval_seed(0, 100) == experiment.eval_seed(0, 100)
    assert experiment.eval_seed(0, 100) != experiment.eval_seed(0, 200)
    assert experiment.eval_seed(0, 100) != experiment.eval_seed(1, 100)
    g = torch.Generator()
    g.manual_seed(experiment.eval_seed(7, 10 ** 9))    # a valid seed


def test_accuracy_takes_device_tensors(tmp_path):
    """trainer.accuracy on tensors gives what it gives on numpy arrays, and
    does not draw from the training generator."""
    exp = mnist.MNIST(mnist.read_args(_argv(tmp_path, 'acc')), device='cpu')
    exp.conclude()
    gen = exp.state.generator.get_state()
    on_numpy = trainer.accuracy(exp.model, exp.X_test, exp.Y_test, seed=3,
                                batch_size=8, num_samples=2)
    on_tensors = trainer.accuracy(exp.model, exp.X_test_dev, exp.Y_test_dev,
                                  seed=3, batch_size=8, num_samples=2)
    assert on_numpy == on_tensors
    assert on_numpy == trainer.accuracy(exp.model, exp.X_test.astype(np.float64),
                                        exp.Y_test[:, 0], seed=3,
                                        batch_size=8, num_samples=2)
    assert exp.test_accuracy() == exp.test_accuracy()
    assert torch.equal(gen, exp.state.generator.get_state())
