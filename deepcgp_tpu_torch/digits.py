"""UCI-digits experiment entry point (counterpart of
``deepcgp_tpu/digits.py``; the same flags and defaults): the MNIST
pipeline (StandardScaler -> conv-GP stack -> robust-max) on the 1,797
real 8x8 scans that scikit-learn bundles, with defaults shrunk to the 8x8
geometry:

    python -m deepcgp_tpu_torch.digits --name digits

Default: one conv-kernel SVGP layer (filter 5, stride 1 -> 16 patches),
M=64 inducing patches, ~17k Adam steps.  It runs on the card;
``main(argv, device='cpu')`` runs it on the CPU.
"""

from __future__ import annotations

from deepcgp_tpu_torch.training import data
from deepcgp_tpu_torch.training.arguments import default_parser
from deepcgp_tpu_torch.training.experiment import Experiment


class Digits(Experiment):
    def _load_data(self):
        (self.X_train, self.Y_train, self.X_test, self.Y_test) = \
            data.digits_data(self.flags)


def read_args(argv=None):
    parser = default_parser()
    parser.add_argument('--tensorboard-dir', type=str,
                        default='/tmp/digits/tensorboard')
    parser.add_argument('-N', type=int, default=1438,
                        help="How many training examples to use.")
    parser.set_defaults(
        # 8x8 geometry: one conv-kernel SVGP layer over 5x5 patches.
        M='64', feature_maps='', filter_sizes='5', strides='1',
        last_kernel='conv',
        # Tiny dataset: decay faster, evaluate often, keep chunks short.
        lr_decay_steps=7000, test_every=1000, test_size=359,
        batch_size=64)
    return parser.parse_args(argv)


def main(argv=None, device=None) -> Digits:
    """Train the whole schedule; returns the concluded experiment."""
    experiment = Digits(read_args(argv), device=device)
    experiment.run()
    return experiment


if __name__ == '__main__':
    main()
