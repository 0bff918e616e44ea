"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: the training set, the held-out set the requests are
drawn from, the weights, and the seeds of the program's random streams.

Everything is made on the run's device by a ``torch.Generator`` in a few
large calls, in float32, the dtype the configurations are served and
trained in.  The same seed gives the same inputs; every seed gives the
same sizes, so the work does not depend on it.
"""

from __future__ import annotations

import torch

from portbench.yardstick import layers

_MASK63 = (1 << 63) - 1


def subseed(seed: int, stream: str) -> int:
    """A seed of its own for each named stream of ``seed`` (any integer)."""
    h = 1469598103934665603
    for ch in f'{int(seed)}/{stream}':
        h = ((h ^ ord(ch)) * 1099511628211) & _MASK63
    return h


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, stream))
    return g


def training_set(config: dict, seed: int, device):
    """(X [N, H*W*C] float32, rows in NHWC order; Y [N, 1] int64), N the
    configuration's ``num_data``: standard normal pixels and uniform
    labels."""
    g = generator(seed, 'training set', device)
    H, W, C = config['image_shape']
    N = config['num_data']
    X = torch.randn((N, H * W * C), generator=g, device=device)
    Y = torch.randint(0, config['num_classes'], (N, 1), generator=g,
                      device=device)
    return X, Y


def held_out_set(config: dict, seed: int, device):
    """[held_out, H*W*C] float32 images: request k of a serving cell takes
    rows block k mod (held_out // rows) of them."""
    g = generator(seed, 'held-out set', device)
    H, W, C = config['image_shape']
    return torch.randn((config['held_out'], H * W * C), generator=g,
                       device=device)


def weights(config: dict, seed: int, device) -> list:
    """Per layer: {'Z' [M, L], 'q_mu' [M, R], 'q_sqrt' [R, M, M] (lower
    triangular, positive diagonal), 'variance', 'lengthscale' (floats),
    'patch_weights' [P] (the last layer)}, float32 tensors.  Z are standard
    normal patches, as patches of the standard normal images are; q_mu,
    q_sqrt and the lengthscales are set by the configuration's
    ``weights`` so that the class probabilities vary."""
    w = config['weights']
    g = generator(seed, 'weights', device)
    out = []
    for i, layer in enumerate(layers(config)):
        M, L, R, P = layer['M'], layer['L'], layer['R'], layer['P']
        q_sqrt = w['q_sqrt_offdiag'] * torch.randn(
            (R, M, M), generator=g, device=device).tril_(-1)
        q_sqrt.diagonal(dim1=-2, dim2=-1).fill_(w['q_sqrt_diag'])
        entry = {'Z': torch.randn((M, L), generator=g, device=device),
                 'q_mu': w['q_mu_scale'] * torch.randn(
                     (M, R), generator=g, device=device),
                 'q_sqrt': q_sqrt,
                 'variance': float(w['variance']),
                 'lengthscale': float(w['lengthscales'][i])}
        if not layer['hidden']:
            entry['patch_weights'] = torch.ones(P, device=device)
        out.append(entry)
    return out
