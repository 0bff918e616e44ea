"""Serve predictions from a trained run (counterpart of the JAX package's
``examples/serve.py``):

    python -m deepcgp_tpu_torch.examples.serve results/mnist_example

Loads the run's snapshot (written by either package's CLI) into a
``Predictor`` and serves batched labels and log-densities for the MNIST
test images.  It runs on the card; ``main(run_dir, device='cpu')`` runs it
on the CPU.
"""

from __future__ import annotations

import sys
import time
import types

import numpy as np

from deepcgp_tpu_torch.serving import Predictor
from deepcgp_tpu_torch.training import data


def main(run_dir: str, device=None):
    """Print the serving rate and accuracy on 1000 test images, then the
    mean predictive log-density of the first 32; returns (accuracy, mean
    log-density)."""
    flags = types.SimpleNamespace(N=2000, test_size=1000, seed=0)
    X_train, _, X_test, Y_test = data.mnist_data(flags)
    pred = Predictor.from_run_dir(run_dir, X_train.shape[1:], batch_size=128,
                                  num_samples=5, device=device)
    # Warm the kernels and allocator, then measure serving throughput.
    pred.predict_proba(X_test[:128])
    t0 = time.perf_counter()
    labels = pred.predict(X_test)
    dt = time.perf_counter() - t0
    acc = float((labels[:, None] == Y_test).mean())
    print(f"served {len(X_test)} points in {dt:.2f}s "
          f"({len(X_test) / dt:.0f} img/s), accuracy {acc:.4f}")
    dens = float(np.mean(pred.log_density(X_test[:32], Y_test[:32])))
    print("mean predictive log-density (first 32):", dens)
    return acc, dens


if __name__ == '__main__':
    main(sys.argv[1] if len(sys.argv) > 1 else 'results/mnist_example')
