"""Turnkey CIFAR-10 accuracy-parity reproduction (counterpart of the JAX
package's ``examples/cifar_parity.py``; the same schedule and threshold).

Reproduces the reference's committed cifar_fm10 ARTIFACT run
(`notebooks/data/cifar_fm10/options.toml`: the flagship 2-layer config --
M=384,384, feature_maps 10, filters 5,5, strides 3,1, Adam, batch 32,
S=10 -- N=50000, lr_decay_steps 100000, test_every 25000, 10 epochs =
250k steps) and checks the final test accuracy against its final row
(0.7385, `log.csv`).  The artifact's log has no lr column; the era's other
committed runs decayed continuously, and so does this recipe (either
schedule gives the same 10 epochs here).  The default threshold carries a
margin (0.73) for trajectory variance across frameworks; ``--threshold
0.7385`` asks for the exact result or better.

Usage (the REAL dataset; the script refuses the synthetic fallback):

    DEEPCGP_DATA_DIR=/path/with/cifar10.npz \\
        python -m deepcgp_tpu_torch.examples.cifar_parity [--threshold 0.7385]

``cifar10.npz`` holds x_train [50000, 3, 32, 32], y_train [50000], x_test
[10000, 3, 32, 32], y_test [10000] (uint8-scale pixel values, NCHW: the
`observations` package's layout, which the reference loaded).  It runs on
the card; ``main(argv, device='cpu')`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

from deepcgp_tpu_torch.cifar import Cifar, read_args
from deepcgp_tpu_torch.training import data as data_lib


def parity_argv(log_dir: str = 'results') -> list:
    """The CIFAR CLI's flags of the artifact run."""
    return ['--name', 'cifar_parity_fm10', '-N', '50000', '-M', '384,384',
            '--feature-maps', '10', '--filter-sizes', '5,5', '--strides',
            '3,1', '--lr-decay-steps', '100000', '--test-every', '25000',
            '--num-samples', '10', '--batch-size', '32',
            '--lr-decay-continuous',
            '--log-dir', log_dir, '--no-tensorboard']


def main(argv=None, device=None) -> int:
    """0 when the final test accuracy reaches the threshold, 1 when it
    does not, 2 without the real dataset."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--threshold', type=float, default=0.73,
                        help="Final-accuracy assertion; the reference's "
                             "committed cifar_fm10 result is 0.7385.")
    parser.add_argument('--log-dir', type=str, default='results')
    args = parser.parse_args(argv)

    npz = os.path.join(data_lib.data_dir(), 'cifar10.npz')
    if not os.path.exists(npz):
        print(f"ERROR: real CIFAR-10 not found at {npz}.\n"
              "Place cifar10.npz (keys x_train, y_train, x_test, y_test) "
              "under $DEEPCGP_DATA_DIR and re-run.", file=sys.stderr)
        return 2

    experiment = Cifar(read_args(parity_argv(args.log_dir)), device=device)
    experiment.run()  # train_steps == the artifact's 10 epochs (250k steps)

    acc = experiment.test_accuracy()
    status = 'PASS' if acc >= args.threshold else 'FAIL'
    print(f"cifar-parity: final test_accuracy={acc:.4f} "
          f"threshold={args.threshold:.4f} "
          f"(reference artifact 0.7385) -> {status}")
    return 0 if acc >= args.threshold else 1


if __name__ == '__main__':
    raise SystemExit(main())
