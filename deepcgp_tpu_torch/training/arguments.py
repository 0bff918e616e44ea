"""Shared CLI flags (counterpart of ``deepcgp_tpu/training/arguments.py``:
the same flags, dests, types and defaults, so an invocation of the JAX
package's CLI runs here verbatim and writes the same ``options.toml``)."""

from __future__ import annotations

import argparse
import math


def train_steps(flags) -> int:
    """Outer-loop count derived from lr-decay geometry: roughly until the
    learning rate reaches 5e-5 (`conv_gp/arguments.py:4-7`)."""
    decay_count = math.log(5e-5 / flags.lr, 0.1)
    return math.ceil(flags.lr_decay_steps * decay_count / flags.test_every)


def default_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--name', type=str, required=True,
                        help="Experiment name; determines the results dir.")
    parser.add_argument('--lr-decay-steps', type=int, default=100000,
                        help="x0.1 exponential lr decay every this many steps.")
    parser.add_argument('--test-every', type=int, default=50000,
                        help="Optimization iterations between evaluations.")
    parser.add_argument('--test-size', type=int, default=10000)
    parser.add_argument('--num-samples', type=int, default=10)
    parser.add_argument('--log-dir', type=str, default='results')
    parser.add_argument('--lr', type=float, default=0.01)
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--optimizer', type=str, default='Adam',
                        help="Adam, NatGrad or SGD")
    parser.add_argument('-M', type=str, default='384,384',
                        help="Inducing points per layer (comma list).")
    parser.add_argument('--feature-maps', type=str, default='10')
    parser.add_argument('--filter-sizes', type=str, default='5,5')
    parser.add_argument('--strides', type=str, default='2,1')
    parser.add_argument('--base-kernel', type=str, default='rbf')
    parser.add_argument('--white', action='store_true', default=False)
    parser.add_argument('--last-kernel', type=str, default='conv')
    parser.add_argument('--gamma', type=float, default=0.001,
                        help="Initial NatGrad step size.")
    parser.add_argument('--identity-mean', action='store_true')
    parser.add_argument('--load-model', type=str, default=None)
    parser.add_argument('--natgrad-warm-steps', type=int, default=0,
                        help="NatGrad only: run this many Adam steps first, "
                             "then hand the warmed model to NatGrad.  From "
                             "a fresh model's 1e-5-scaled q_sqrt init, "
                             "NatGrad sits on a chance-level plateau (small "
                             "gamma) or diverges into Cholesky backoff "
                             "(large gamma); a short Adam phase places the "
                             "variational state in the basin.")
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--mesh', type=str, default='',
                        help="Device mesh spec, e.g. 'data=4,model=2' "
                             "over the ranks of --distributed; empty = one "
                             "card (or every rank on 'data').")
    parser.add_argument('--no-tensorboard', action='store_true')
    parser.add_argument('--lr-decay-continuous', action='store_true',
                        help="Continuous (non-staircase) exponential lr "
                             "decay — the schedule the reference's "
                             "committed result artifacts were trained "
                             "with; its current source uses staircase "
                             "(the default here).")
    parser.add_argument('--distributed', action='store_true',
                        help="Multi-process training: join the process "
                             "group from RANK, WORLD_SIZE, MASTER_ADDR, "
                             "MASTER_PORT and LOCAL_RANK (as torchrun sets "
                             "them).")
    parser.add_argument('--full-state-ckpt', action='store_true',
                        help="Also checkpoint the FULL train state (model + "
                             "optimizer moments + generator state) and "
                             "auto-resume from it; the reference-style .npy "
                             "snapshot drops optimizer state.")
    return parser
