"""MNIST / fashion-MNIST experiment entry point (counterpart of
``deepcgp_tpu/mnist.py``; the same flags), e.g. the M=1024 configuration:

    python -m deepcgp_tpu_torch.mnist --name m1024 -N 60000 -M 1024 \
        --feature-maps '' --filter-sizes 5 --strides 1 --last-kernel rbf \
        --batch-size 128 --optimizer NatGrad --natgrad-warm-steps 20

It runs on the card; ``main(argv, device='cpu')`` runs it on the CPU.
"""

from __future__ import annotations

from deepcgp_tpu_torch.training import data
from deepcgp_tpu_torch.training.arguments import default_parser
from deepcgp_tpu_torch.training.experiment import Experiment


class MNIST(Experiment):
    def _load_data(self):
        (self.X_train, self.Y_train, self.X_test, self.Y_test) = \
            data.mnist_data(self.flags, fashion=self.flags.fashion)


def read_args(argv=None):
    parser = default_parser()
    parser.add_argument('--fashion', action='store_true', default=False,
                        help="Use fashion MNIST instead of regular MNIST.")
    parser.add_argument('--tensorboard-dir', type=str,
                        default='/tmp/mnist/tensorboard')
    parser.add_argument('-N', type=int, default=60000,
                        help="How many training examples to use.")
    return parser.parse_args(argv)


def main(argv=None, device=None) -> MNIST:
    """Train the whole schedule; returns the concluded experiment."""
    experiment = MNIST(read_args(argv), device=device)
    experiment.run()
    return experiment


if __name__ == '__main__':
    main()
