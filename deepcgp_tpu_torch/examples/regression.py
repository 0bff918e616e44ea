"""Deep GP regression with a Gaussian likelihood (counterpart of the JAX
package's ``examples/regression.py``): two plain SVGP layers over 256
points of a noisy step function, trained with Adam.

    python -m deepcgp_tpu_torch.examples.regression

It runs on the card; ``main(device='cpu')`` runs it on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from deepcgp_tpu_torch import config
from deepcgp_tpu_torch.models.base_kernels import RBF
from deepcgp_tpu_torch.models.dgp import DGP
from deepcgp_tpu_torch.models.layers import SVGPLayer, fresh_q_sqrt
from deepcgp_tpu_torch.models.likelihoods import Gaussian
from deepcgp_tpu_torch.models.mean_functions import Zero
from deepcgp_tpu_torch.ops.kmeans import kmeans
from deepcgp_tpu_torch.ops.linalg import add_jitter
from deepcgp_tpu_torch.training import trainer
from deepcgp_tpu_torch.training.trainer import TrainConfig


def svgp_layer(Z: torch.Tensor, num_outputs: int) -> SVGPLayer:
    """An SVGP layer over an RBF (variance 1, lengthscale 1) with a zero
    mean: q_mu = 0 and q_sqrt = chol(Kuu) tiled over the outputs."""
    kernel = RBF.create(variance=1.0, lengthscales=1.0, dtype=Z.dtype,
                        device=Z.device)
    q_mu = Z.new_zeros(Z.shape[0], num_outputs)
    q_sqrt = fresh_q_sqrt(add_jitter(kernel.K(Z), config.JITTER), num_outputs)
    return SVGPLayer(kernel, Z, q_mu, q_sqrt, Zero(num_outputs),
                     num_outputs=num_outputs)


def build_regression_dgp(X: torch.Tensor, num_inducing: int = 32,
                         hidden_dim: int = 2, seed: int = 0) -> DGP:
    """The hidden layer's Z by k-means++ of X [N, D] (on X's device, its
    draws from a generator seeded with ``seed``), the output layer's
    standard normal [num_inducing, hidden_dim] from
    ``np.random.RandomState(seed)``, as the JAX example draws it;
    ``Gaussian(0.1)``, S = 5."""
    g = torch.Generator(device=X.device)
    g.manual_seed(seed)
    Z = kmeans(X, num_inducing, generator=g, init='k-means++')
    Z2 = torch.as_tensor(np.random.RandomState(seed).randn(num_inducing,
                                                           hidden_dim),
                         dtype=X.dtype, device=X.device)
    likelihood = Gaussian.create(0.1, dtype=X.dtype, device=X.device)
    return DGP([svgp_layer(Z, hidden_dim), svgp_layer(Z2, 1)], likelihood,
               num_data=X.shape[0], num_samples=5)


def step_data(seed: int = 0, n: int = 256):
    """n sorted points uniform on [-3, 3] and the step function's -1/+1
    plus 0.05 standard normal noise: (X [n, 1], Y [n, 1]) float32."""
    rng = np.random.RandomState(seed)
    X = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    Y = np.where(X < 0, -1.0, 1.0) + 0.05 * rng.randn(n, 1)
    return X.astype(np.float32), Y.astype(np.float32)


def main(argv=None, device=None) -> float:
    """Train 5 chunks of ``--steps-per-chunk`` Adam steps (lr 0.01, batch
    64), printing the ELBO per point after each; returns the train RMSE
    of the predictive mean over 10 samples."""
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--steps-per-chunk', type=int, default=400)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    device = config.default_device(device)
    X, Y = step_data(args.seed)
    Xd = torch.as_tensor(X, device=device)
    Yd = torch.as_tensor(Y, device=device)
    model = build_regression_dgp(Xd, seed=args.seed)
    cfg = TrainConfig(optimizer='Adam', lr=0.01, lr_decay_steps=2000,
                      gamma=0.001, batch_size=64)
    state = trainer.init_state(model, cfg, seed=args.seed + 1)
    for _ in range(5):
        elbos = trainer.run_chunk(state, cfg, Xd, Yd, args.steps_per_chunk)
        print(f"step {int(state.step)}: elbo/point "
              f"{float(elbos[-1]) / X.shape[0]:.4f}", flush=True)
    g = torch.Generator(device=device)
    g.manual_seed(args.seed + 2)
    mean, _ = model.predict_y(Xd, 10, generator=g)
    rmse = float((mean.mean(0) - Yd).square().mean().sqrt())
    print(f"train RMSE {rmse:.4f} (noise floor ~0.05)", flush=True)
    return rmse


if __name__ == '__main__':
    main()
