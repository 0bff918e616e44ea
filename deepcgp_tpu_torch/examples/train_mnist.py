"""Train a 2-layer deep convolutional GP on MNIST (counterpart of the JAX
package's ``examples/train_mnist.py``, the reference's headline run,
`README.md:22-24`):

    python -m deepcgp_tpu_torch.examples.train_mnist

Put the real data at ``$DEEPCGP_DATA_DIR/mnist.npz`` (keys x_train,
y_train, x_test, y_test) to reproduce the paper's numbers; without it the
deterministic synthetic fallback keeps the example runnable.  It runs on
the card; ``main(device='cpu')`` runs it on the CPU.
"""

from __future__ import annotations

from deepcgp_tpu_torch import mnist

ARGV = [
    '--name', 'mnist_example',
    '-N', '60000', '-M', '384,384',
    '--feature-maps', '10', '--filter-sizes', '5,5', '--strides', '2,1',
    '--batch-size', '32', '--num-samples', '10',
    '--test-every', '5000', '--lr-decay-steps', '30000',
    '--log-dir', 'results',
    '--full-state-ckpt',          # preemption-safe full-state resume
]


def main(argv=ARGV, device=None) -> mnist.MNIST:
    """Train the whole schedule of ``argv``; returns the concluded
    experiment."""
    return mnist.main(list(argv), device=device)


if __name__ == '__main__':
    main()
