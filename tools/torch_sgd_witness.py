#!/usr/bin/env python3
"""Why the plain-SGD trajectory case of the port's training test can part
from the JAX package's: witnesses at identical parameters, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_sgd_witness.py [--lr 0.01 1e-4]

For each learning rate, tests/test_torch_training.py's SGD trajectory
(float64, the small 2-layer conv model, the JAX package's draws replayed)
runs 3 steps.  After each step it prints, as one JSON line: both ELBOs
and their relative gap; the largest parameter gap relative to its leaf's
largest magnitude; the ELBOs of the JAX model and of the port filled with
the JAX model's leaves (``convert.load_jax_leaves``) on one fresh batch
and draw, and their gap; each layer's KL from both at those leaves; layer
0's lengthscale and variance; and the largest diagonal entry of the
squared self-distance of layer 0's Z / lengthscale from each package
(exactly 0 in exact arithmetic).

Two more readings at the same leaves, batch and draw take the self-
distance's rounding out of the comparison: ``jax_self_distance_in_port``
evaluates the port with every self-gram's squared distance (Kuu's) taken
from the JAX package's ``square_distance``, and ``exact_diagonal`` both
packages with that distance's diagonal set to its exact 0.  Where both
gaps fall to rounding (below 1e-9) while the plain gap does not, the
ELBOs part only by how each package rounds Kuu's diagonal.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import jax

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]

import deepcgp_tpu.models.base_kernels as jbase  # noqa: E402
import deepcgp_tpu_torch.models.base_kernels as tbase  # noqa: E402
from deepcgp_tpu.ops.distances import square_distance as jsd  # noqa: E402
from deepcgp_tpu_torch.convert import load_jax_leaves  # noqa: E402
from deepcgp_tpu_torch.ops.distances import square_distance as tsd  # noqa: E402
from test_torch_training import (SMALL_IMAGE, _trajectory, jax_draws,  # noqa: E402
                                 jax_leaf, port_of, small_flags)


def gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


@contextlib.contextmanager
def distance(module, fn):
    """``module.square_distance`` replaced by ``fn`` inside the block."""
    old = module.square_distance
    module.square_distance = fn
    try:
        yield
    finally:
        module.square_distance = old


def jax_self_distance(X, X2=None):
    """The port's distance with its self-grams from the JAX package."""
    if X2 is not None:
        return tsd(X, X2)
    return torch.as_tensor(np.asarray(jsd(jnp.asarray(X.detach().numpy()))))


def zero_diagonal(fn, eye):
    """``fn`` whose self-grams have their exact 0 diagonal."""
    def d2(X, X2=None):
        d = fn(X, X2)
        return d if X2 is not None else d * (1 - eye(d.shape[-1], dtype=d.dtype))
    return d2


def witness(lr: float, steps: int) -> None:
    rng = np.random.RandomState(0)       # the trajectory's data
    X = rng.randn(96, *SMALL_IMAGE).reshape(96, -1)
    Y = rng.randint(0, 10, size=(96, 1))
    idx = np.random.RandomState(7).randint(0, 96, size=8)
    for t, state_j, elbo_j, state, elbo in _trajectory(False, 'SGD', steps,
                                                        lr=lr):
        jm = state_j.model
        param_gap = 0.0
        for name, p in state.params.items():
            ref = jax_leaf(jm, name)
            p = p.detach().numpy()
            if name.endswith('q_sqrt'):
                ref, p = np.tril(ref), np.tril(p)
            param_gap = max(param_gap, float(np.abs(p - ref).max()
                                             / np.abs(ref).max()))
        leaves = {''.join(str(k) for k in path): np.asarray(leaf)
                  for path, leaf in jax.tree_util.tree_flatten_with_path(jm)[0]}
        port = load_jax_leaves(port_of(jm, small_flags(False), SMALL_IMAGE),
                               leaves)
        key = jax.random.PRNGKey(11)
        noise = jax_draws(jm, key, 8)

        def elbos():
            return (float(jm.elbo(jnp.asarray(X[idx]), jnp.asarray(Y[idx]),
                                  key)),
                    float(port.elbo(torch.as_tensor(X[idx]),
                                    torch.as_tensor(Y[idx]), noise=noise)))

        same_j, same_p = elbos()
        with distance(tbase, jax_self_distance):
            jsd_j, jsd_p = elbos()
        with distance(tbase, zero_diagonal(tsd, torch.eye)), \
                distance(jbase, zero_diagonal(jsd, jnp.eye)):
            exact_j, exact_p = elbos()
        jc, pc = jm.precompute(), port.precompute()
        kls = [(float(jl.KL(jc[i])), float(pl.KL(pc[i])))
               for i, (jl, pl) in enumerate(zip(jm.layers, port.layers))]
        base = jm.layers[0].base_kernel
        ls = float(base.lengthscales)
        Z = np.asarray(jm.layers[0].Z) / ls
        print(json.dumps({
            'lr': lr, 'step': t, 'elbo_jax': elbo_j, 'elbo_port': elbo,
            'elbo_gap': gap(elbo, elbo_j), 'param_gap_of_leaf_max': param_gap,
            'same_leaves_elbo_jax': same_j, 'same_leaves_elbo_port': same_p,
            'same_leaves_elbo_gap': gap(same_p, same_j),
            'jax_self_distance_in_port': {'elbo_jax': jsd_j, 'elbo_port': jsd_p,
                                          'gap': gap(jsd_p, jsd_j)},
            'exact_diagonal': {'elbo_jax': exact_j, 'elbo_port': exact_p,
                               'gap': gap(exact_p, exact_j)},
            'same_leaves_kl': [{'jax': a, 'port': b, 'gap': gap(b, a)}
                               for a, b in kls],
            'layer0_lengthscale': ls, 'layer0_variance': float(base.variance),
            'layer0_self_distance_diag_max': {
                'jax': float(np.diag(np.asarray(jsd(jnp.asarray(Z)))).max()),
                'port': float(torch.diagonal(tsd(torch.as_tensor(Z))).max())}}),
            flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--lr', type=float, nargs='+', default=[0.01, 1e-4])
    ap.add_argument('--steps', type=int, default=3)
    args = ap.parse_args()
    for lr in args.lr:
        witness(lr, args.steps)


if __name__ == '__main__':
    main()
