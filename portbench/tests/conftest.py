"""Shared pieces of the benchmark's CPU tests: a tiny configuration of
the flagship's kind (two layers, a fused-kind ConvKernel last layer) and
tiny traffic, run through the harness on the CPU."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(name='tiny', reference='convgp', image_shape=[12, 12, 3],
            num_classes=10, num_data=64, held_out=40, M=[16, 16],
            feature_maps=[3], filter_sizes=[3, 3], strides=[2, 1],
            base_kernel='rbf', last_kernel='conv', white=False,
            identity_mean=False, dtype='float32', lr=0.01,
            lr_decay_steps=3, lr_decay_continuous=True,
            weights=dict(variance=5.0, lengthscales=[5.0, 25.0],
                         q_mu_scale=0.5, q_sqrt_offdiag=0.05,
                         q_sqrt_diag=0.3))
TRAFFIC = {'train': dict(kind='train', optimizer='Adam', batch=8, samples=2,
                         chunk_steps=5),
           'serve': dict(kind='serve', rows=8, samples=2, warmup_requests=2,
                         traced_requests=3, compared_requests=4)}
CELLS = {'train': 'cifar10-convgp-2l.train-adam-b32',
         'serve': 'cifar10-convgp-2l.serve-b128'}


@pytest.fixture
def tiny_spec():
    """tiny_spec(kind): the flagship's cell of that kind, with its limits,
    at the tiny configuration and traffic."""
    from portbench import harness

    def make(kind):
        spec = harness.cell(CELLS[kind])
        spec['config'] = dict(TINY)
        spec['traffic'] = dict(TRAFFIC[kind])
        return spec
    return make
