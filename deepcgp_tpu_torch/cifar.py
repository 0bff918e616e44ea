"""CIFAR-10 experiment entry point (counterpart of ``deepcgp_tpu/cifar.py``;
the same flags), e.g. the flagship configuration:

    python -m deepcgp_tpu_torch.cifar --name flagship -N 50000 \
        -M 384,384 --feature-maps 10 --filter-sizes 5,5 --strides 3,1

It runs on the card; ``main(argv, device='cpu')`` runs it on the CPU.
"""

from __future__ import annotations

from deepcgp_tpu_torch.training import data
from deepcgp_tpu_torch.training.arguments import default_parser
from deepcgp_tpu_torch.training.experiment import Experiment


class Cifar(Experiment):
    def _load_data(self):
        (self.X_train, self.Y_train, self.X_test, self.Y_test) = \
            data.cifar_data(self.flags)


def read_args(argv=None):
    parser = default_parser()
    parser.add_argument('--tensorboard-dir', type=str,
                        default='/tmp/cifar10/tensorboard')
    parser.add_argument('-N', type=int, default=50000,
                        help="Use N training examples.")
    # The reference CIFAR entry evaluates on the ENTIRE test set (moved
    # train tail + real test, `conv_gp/cifar.py:19-22`); test_size is an
    # opt-in subsample here, so default it off for parity.
    parser.set_defaults(test_size=None)
    return parser.parse_args(argv)


def main(argv=None, device=None) -> Cifar:
    """Train the whole schedule; returns the concluded experiment."""
    experiment = Cifar(read_args(argv), device=device)
    experiment.run()
    return experiment


if __name__ == '__main__':
    main()
