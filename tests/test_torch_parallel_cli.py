"""The port's CLI across processes on the CPU: ``MNIST`` and ``Cifar``
under ``--mesh data=2 --distributed`` in two gloo processes (float64, the
synthetic fallback), held to the one-process run of the same flags.

One spawned group runs an MNIST run of 3 chunks, the same run stopped
after one chunk and resumed from its ``state_<step>.pt`` by a new
Experiment, and a Cifar run of 2 chunks with its TensorBoard log.  Their
``log.csv`` rows equal the one-process runs' (train ELBO and test
accuracy at rtol 1e-6, step and learning rate exactly; the test set of
41 rows leaves a last batch of 9 that pads to the data size), the resumed
run equals the unbroken one, rank 0 alone writes, and each rank keeps
its ``process_shard`` of the training set resident."""

import csv
import functools
import os

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from deepcgp_tpu_torch import cifar, config, mnist
from deepcgp_tpu_torch.parallel.train import free_port, run_processes
from deepcgp_tpu_torch.training import data

WORLD = 2
TINY = ['-N', '64', '-M', '4,4', '--feature-maps', '2', '--filter-sizes',
        '5,5', '--strides', '2,2', '--test-every', '2', '--lr-decay-steps',
        '4', '--test-size', '41', '--num-samples', '2', '--batch-size', '8']
COLUMNS = ('global_step', 'lr', 'test_accuracy', 'train_elbo')


def _argv(root, name, *extra):
    return ['--name', name, *TINY, '--log-dir', str(root), *extra]


def _rows(path):
    with open(path) as f:
        return [r for r in csv.DictReader(f) if r['Entry'] != 'Entry']


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The two-process runs (one spawned group) and the one-process runs
    of the same flags, in float64 on the synthetic fallback."""
    mpatch = pytest.MonkeyPatch()
    empty = tmp_path_factory.mktemp('no_data')
    mpatch.setenv('DEEPCGP_DATA_DIR', str(empty))
    two, one = tmp_path_factory.mktemp('two'), tmp_path_factory.mktemp('one')
    tb = str(two / 'tb')
    specs = {
        'mnist': ('mnist', _argv(two / 'a', 'run', '--no-tensorboard',
                                 '--full-state-ckpt'), 3, 0),
        'resume': ('mnist', _argv(two / 'b', 'run', '--no-tensorboard',
                                  '--full-state-ckpt'), 3, 1),
        'cifar': ('cifar', _argv(two / 'c', 'run', '--tensorboard-dir', tb),
                  2, 0)}
    out_dir = tmp_path_factory.mktemp('ranks')
    try:
        run_processes(worker.cli_worker, WORLD,
                      (WORLD, free_port(), specs, str(out_dir)), timeout=300)
        mpatch.setattr(config, 'FLOAT_TYPE', torch.float64)
        for name in ('mnist_data', 'cifar_data'):
            mpatch.setattr(data, name, functools.partial(
                getattr(data, name), dtype=np.float64))
        for module, cls, run_dir, chunks in ((mnist, mnist.MNIST, 'a', 3),
                                             (cifar, cifar.Cifar, 'c', 2)):
            exp = cls(module.read_args(_argv(one / run_dir, 'run',
                                             '--no-tensorboard')),
                      device='cpu')
            try:
                for _ in range(chunks):
                    exp.train_step()
            finally:
                exp.conclude()
    finally:
        mpatch.undo()
    views = [torch.load(out_dir / f'rank{r}.pt', weights_only=False)
             for r in range(WORLD)]
    return two, one, views, tb


def _assert_rows_equal(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for col in COLUMNS:
            np.testing.assert_allclose(float(g[col]), float(w[col]),
                                       rtol=rtol, err_msg=col)


@pytest.mark.parametrize('entry,run_dir', [('mnist', 'a'), ('cifar', 'c')])
def test_two_process_log_equals_one_process(runs, entry, run_dir):
    two, one, _, _ = runs
    got = _rows(two / run_dir / 'run' / 'log.csv')
    want = _rows(one / run_dir / 'run' / 'log.csv')
    assert len(want) == (3 if entry == 'mnist' else 2)
    _assert_rows_equal(got, want, 1e-6)


def test_resume_equals_the_unbroken_two_process_run(runs):
    """Stopped after one chunk, resumed by a new Experiment on both ranks
    from rank 0's ``state_2.pt``: the rows after the resume are the
    unbroken run's, bit for bit."""
    two, _, views, _ = runs
    assert all(v['resume']['resumed_at'] == 2 for v in views)
    got = _rows(two / 'b' / 'run' / 'log.csv')
    want = _rows(two / 'a' / 'run' / 'log.csv')
    _assert_rows_equal(got, want, 0.0)
    states = sorted(os.listdir(two / 'b' / 'run_state'))
    assert states == ['state_2.pt', 'state_4.pt', 'state_6.pt']


def test_one_writer(runs):
    """Rank 0 writes log.csv (one row a chunk: no rank wrote twice),
    options.toml, the snapshot and the TensorBoard events; rank 1
    writes nothing."""
    two, _, views, tb = runs
    assert [v['mnist']['writer'] for v in views] == [True, False]
    assert len(_rows(two / 'a' / 'run' / 'log.csv')) == 3
    assert (two / 'a' / 'run' / 'options.toml').exists()
    assert (two / 'a' / 'run.npy').exists()
    assert len(os.listdir(os.path.join(tb, 'run'))) == 1


def test_mesh_uses_the_multihost_input_path(runs):
    """With --mesh and --distributed each rank keeps its process_shard of
    the training set resident: half of the 64 rows."""
    _, _, views, _ = runs
    for v in views:
        assert (v['mnist']['N'], v['mnist']['rows']) == (64, 32)
        assert (v['cifar']['N'], v['cifar']['rows']) == (64, 32)
