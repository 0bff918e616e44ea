"""Feature-map sweep on CIFAR-10 -- the reference's `fm_experiment.ipynb` /
`notebooks/data/cifar_fm*` experiment as a script (counterpart of the JAX
package's ``examples/fm_sweep.py``):

    python -m deepcgp_tpu_torch.examples.fm_sweep --feature-maps 1 2 5 10 --chunks 5

Each sweep point trains the 2-layer conv GP with C feature maps and
records its final test accuracy and mean training ELBO in
<log-dir>/fm_sweep_summary.csv (each point's own log.csv follows the
reference's committed results layout).  It runs on the card;
``main(argv, device='cpu')`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import os

from deepcgp_tpu_torch.cifar import Cifar, read_args


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--feature-maps', type=int, nargs='+',
                        default=[1, 2, 5, 10])
    parser.add_argument('--chunks', type=int, default=5,
                        help="test_every-sized training chunks per point.")
    parser.add_argument('--test-every', type=int, default=1000)
    parser.add_argument('--log-dir', type=str, default='results/fm_sweep')
    return parser.parse_args(argv)


def point_argv(fm: int, test_every: int, chunks: int, log_dir: str) -> list:
    """The CIFAR CLI's flags of one sweep point."""
    return ['--name', f'fm{fm}', '-M', '384,384',
            '--feature-maps', str(fm), '--filter-sizes', '5,5',
            '--strides', '3,1', '--batch-size', '32', '--num-samples', '10',
            '--test-every', str(test_every),
            '--lr-decay-steps', str(test_every * chunks),
            '--log-dir', log_dir, '--no-tensorboard']


def main(argv=None, device=None) -> list:
    """Train every point; returns the summary rows."""
    args = parse_args(argv)
    rows = []
    for fm in args.feature_maps:
        exp = Cifar(read_args(point_argv(fm, args.test_every, args.chunks,
                                         args.log_dir)), device=device)
        try:
            for _ in range(args.chunks):
                exp.train_step()
            rows.append({'feature_maps': fm,
                         'test_accuracy': exp.test_accuracy(),
                         'train_elbo': exp.last_mean_elbo})
        finally:
            exp.conclude()
        print(f"C={fm}: {rows[-1]}", flush=True)

    out = os.path.join(args.log_dir, 'fm_sweep_summary.csv')
    os.makedirs(args.log_dir, exist_ok=True)
    with open(out, 'w', newline='') as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {out}")
    return rows


if __name__ == '__main__':
    main()
