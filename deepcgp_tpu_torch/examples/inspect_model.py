"""Analyse a trained run: the library form of the reference's notebooks
(counterpart of the JAX package's ``examples/inspect_model.py``):

    python -m deepcgp_tpu_torch.examples.inspect_model results/mnist_example

Prints the per-layer output shapes and the noise-robustness accuracies,
writes the first layer's inducing-patch tiling and the 2-D patch
embeddings as .npy arrays in the run dir, and renders the notebook
figures (inducing-patch grid, patch-embedding scatter, noise-robustness
curve -- `notebooks/Inspect.ipynb`) as PNGs there, with no plotting
library (``utils/figures``).  The JAX script's ``PRNGKey(0)`` and
``PRNGKey(1)`` are the seeds 0 and 1 here.  It runs on the card;
``main(run_dir, device='cpu')`` runs it on the CPU.
"""

from __future__ import annotations

import os
import sys
import types

import numpy as np
import torch

from deepcgp_tpu_torch.serving import Predictor
from deepcgp_tpu_torch.training import data
from deepcgp_tpu_torch.utils import figures
from deepcgp_tpu_torch.utils import inspect as insp


def main(run_dir: str, device=None) -> list:
    """Write the arrays and figures; returns the paths written."""
    flags = types.SimpleNamespace(N=2000, test_size=1000, seed=0)
    X_train, _, X_test, Y_test = data.mnist_data(flags)
    model = Predictor.from_run_dir(run_dir, X_train.shape[1:],
                                   device=device).model
    X_flat = X_test.reshape(len(X_test), -1)

    # Per-layer features for embedding/visualisation (notebooks' propagate).
    g = torch.Generator(device=model.layers[0].Z.device).manual_seed(0)
    samples, _, _ = insp.layer_features(model, X_flat[:256], generator=g)
    print("layer output shapes:", [s.shape for s in samples])

    written = []

    def save(name, array):
        path = os.path.join(run_dir, name)
        np.save(path, array)
        written.append(path)
        return path

    # Inducing-patch tiling of the first conv layer.
    grid = insp.inducing_patch_grid(model.layers[0])
    print(f"inducing grid {grid.shape} -> {save('inducing_grid.npy', grid)}")

    # 2-D embedding of inducing patches vs data patches.
    emb_z, emb_d = insp.patch_embedding(model.layers[0], X_train[:500])
    save('embedding_inducing.npy', emb_z)
    save('embedding_data.npy', emb_d)

    # Noise robustness (Inspect.ipynb's sweep).
    accs = insp.noise_robustness(model, X_test, Y_test, seed=1)
    for sigma, acc in accs.items():
        print(f"noise sigma={sigma:.2f}: accuracy {acc:.4f}")

    # The notebooks' figures as PNGs; render_run_figures skips the patch
    # figures of a layer without a patch view.
    for p in figures.render_run_figures(run_dir, model, X_train[:500],
                                        X_flat, Y_test, 1, accuracies=accs):
        print(f"wrote {p}")
        written.append(p)
    return written


if __name__ == '__main__':
    main(sys.argv[1] if len(sys.argv) > 1 else 'results/mnist_example')
