"""Turnkey MNIST accuracy-parity reproduction (counterpart of the JAX
package's ``examples/mnist_parity.py``; the same modes, thresholds and
schedules).

TWO acceptance targets, both reference-committed artifacts of one schedule
family (a single ConvKernel SVGP layer, lr 0.01, lr_decay_steps 25000,
test_every 5000, continuous decay, 15 epochs):

* default        -- N=60000, M=64 (the reference's `results/N60000_M64/`),
                    final accuracy 0.9769;
* ``--m1024``    -- N=60000, M=1024 (`results/N60000_M1024/`), the
                    north-star headline, final accuracy 0.9865.

The artifacts' lr column is 0.01 * 0.1^(t/25000) -- continuous decay --
over 15 logged rows (75k steps), while the reference's current source
decays in steps and ``train_steps`` would stop the same flags at 60k; the
script reproduces the ARTIFACT.  The default thresholds carry a margin
(0.974 / 0.983) for trajectory variance across frameworks (other random
streams, other minibatches); ``--threshold 0.9769`` asks for the exact
result or better.  ``--fast`` runs a shortened schedule (N=10000, the
flags' own schedule) whose check is 0.95 against the N=10000 baseline
row (0.9726, `results/N10000_M100/log.csv`).

Usage (the REAL dataset; the script refuses the synthetic fallback):

    DEEPCGP_DATA_DIR=/path/with/mnist.npz \\
        python -m deepcgp_tpu_torch.examples.mnist_parity [--m1024] [--fast]

``mnist.npz`` holds x_train [60000, 784], y_train [60000], x_test
[10000, 784], y_test [10000] (uint8-scale pixel values).  It runs on the
card; ``main(argv, device='cpu')`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

from deepcgp_tpu_torch.mnist import MNIST, read_args
from deepcgp_tpu_torch.training import data as data_lib

ARTIFACT_EPOCHS = 15          # artifact log rows 0..14 -> 75k steps


def parity_argv(log_dir: str = 'results', m1024: bool = False,
                fast: bool = False) -> list:
    """The MNIST CLI's flags of one mode."""
    if fast:
        return ['--name', 'mnist_parity_fast', '-N', '10000', '-M', '64',
                '--feature-maps', '', '--filter-sizes', '5', '--strides', '1',
                '--lr-decay-steps', '5000', '--test-every', '5000',
                '--log-dir', log_dir, '--no-tensorboard']
    M = '1024' if m1024 else '64'
    return ['--name', f'mnist_parity_m{M}', '-N', '60000', '-M', M,
            '--feature-maps', '', '--filter-sizes', '5', '--strides', '1',
            '--lr-decay-steps', '25000', '--test-every', '5000',
            '--lr-decay-continuous',
            '--log-dir', log_dir, '--no-tensorboard']


def main(argv=None, device=None) -> int:
    """0 when the final test accuracy reaches the threshold, 1 when it
    does not, 2 without the real dataset or for --fast with --m1024."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--threshold', type=float, default=None,
                        help="Final-accuracy assertion; default 0.974 "
                             "against the reference's committed M=64 "
                             "result 0.9769, 0.983 against 0.9865 with "
                             "--m1024, 0.95 with --fast.")
    parser.add_argument('--m1024', action='store_true',
                        help="North-star config: N=60000, M=1024 "
                             "(results/N60000_M1024, 0.9865 final).")
    parser.add_argument('--fast', action='store_true',
                        help="N=10000 shortened schedule for smoke checks.")
    parser.add_argument('--log-dir', type=str, default='results')
    args = parser.parse_args(argv)

    npz = os.path.join(data_lib.data_dir(), 'mnist.npz')
    if not os.path.exists(npz):
        print(f"ERROR: real MNIST not found at {npz}.\n"
              "Place mnist.npz (keys x_train, y_train, x_test, y_test) "
              "under $DEEPCGP_DATA_DIR and re-run.", file=sys.stderr)
        return 2
    if args.fast and args.m1024:
        print("ERROR: --fast runs the M=64 N=10000 smoke config only; "
              "drop one of --fast / --m1024.", file=sys.stderr)
        return 2
    if args.fast:
        threshold = 0.95
    else:
        threshold = 0.983 if args.m1024 else 0.974
    if args.threshold is not None:
        threshold = args.threshold

    experiment = MNIST(read_args(parity_argv(args.log_dir, args.m1024,
                                             args.fast)), device=device)
    if args.fast:
        experiment.run()  # the flags' own schedule
    else:
        try:
            for _ in range(ARTIFACT_EPOCHS):
                experiment.train_step()
        finally:
            experiment.conclude()

    acc = experiment.test_accuracy()
    status = 'PASS' if acc >= threshold else 'FAIL'
    # The smoke config is of the M=64 family.
    ref = 0.9865 if args.m1024 else 0.9769
    print(f"mnist-parity: final test_accuracy={acc:.4f} "
          f"threshold={threshold:.4f} "
          f"(reference artifact {ref}) -> {status}")
    return 0 if acc >= threshold else 1


if __name__ == '__main__':
    raise SystemExit(main())
