"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``portbench/reference``) on the same inputs.

Training: the set-up's first three steps through the window's own call,
as three readings of the program -- each step's loss, the first gradient
as the optimizer holds it after one step (Adam's first moment over
1 - b1), the parameters' change after the three steps -- against the
reference's three steps from the same weights, batches and noise.  The
numbers compared:

* ``loss_rel``: the largest |loss - reference| / |reference| of the three;
* ``grad_gap``: by the worst leaf, |norm(g) - norm(g_ref)| over the larger
  of norm(g_ref) and the median leaf's norm(g_ref);
* ``change_gap``: the same of the parameters' change after three steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (a leaf whose gradient is nought to rounding moves
  under Adam by round-off alone);
* ``grad_err_median``: by the median leaf, norm(g - g_ref) over the larger
  of norm(g_ref) and the median leaf's norm(g_ref).  The worst leaf's
  norm gap is one scalar hyperparameter's gradient, a sum of large terms
  that cancel, whose error swings over decades from seed to seed in
  float32 as in TF32; the norm gap of a large leaf averages a random
  error away.  The median leaf's error of the first gradient is steady
  from seed to seed, and it is the number that the TF32 control fails.

Serving: ``prob_gap``, the largest |p - p_ref| over every class of every
row of the requests compared.
"""

from __future__ import annotations

import json
import math
import os

import torch

from portbench import inputs
from portbench.reference import convgp as ref

HERE = os.path.dirname(os.path.abspath(__file__))


def limits(workload: str) -> dict:
    """{number: limit} of a cell, from ``portbench/limits/<cell>.json``."""
    with open(os.path.join(HERE, 'limits', f'{workload}.json')) as f:
        return {k: v['limit'] for k, v in json.load(f).items()}


def initial_params(config: dict, weights: list, dtype) -> dict:
    """The trainable leaves, by the program's names, from the weights:
    positive parameters stored raw as float32 values, as the program's
    float32 leaves hold them."""
    spec = ref.Spec(config)
    out = {}
    for i, w in enumerate(weights):
        pre = f'layers.{i}.'
        kern = pre + ('base_kernel.' if i < spec.depth - 1
                      else 'kernel.base_kernel.')
        device = w['Z'].device
        for name, value in (('raw_variance', w['variance']),
                            ('raw_lengthscales', w['lengthscale'])):
            raw = torch.tensor(ref.raw_positive(value), dtype=torch.float32,
                               device=device)
            out[kern + name] = raw.to(dtype)
        if 'patch_weights' in w:
            out[pre + 'kernel.patch_weights'] = w['patch_weights'].to(dtype)
        for name in ('Z', 'q_mu', 'q_sqrt'):
            out[pre + name] = w[name].to(dtype)
    return {k: out[k] for k in spec.leaf_names()}


def reference_steps(ar: ref.Arith, config: dict, traffic: dict,
                    weights: list, X, Y, train_seed: int, dither_seed: int,
                    steps: int = 3, half_batch: bool = False):
    """The reference's first ``steps`` optimizer steps in ``ar``'s
    precision: (losses, first gradients {leaf: tensor}, parameters after
    the steps).  The batches and the noise are drawn from ``train_seed``
    as the program's training stream draws them.  ``half_batch`` plants
    a fault: half of each batch left out, the mean taken over the rest."""
    spec = ref.Spec(config)
    device = X.device
    params = {k: p.clone().requires_grad_(True) for k, p in
              initial_params(config, weights, ar.dtype).items()}
    anchors = {i: params[f'layers.{i}.Z'].detach().clone()
               for i in range(spec.depth - 1)}
    g = torch.Generator(device=device)
    g.manual_seed(train_seed)
    adam = ref.Adam(params, config['lr'], config['lr_decay_steps'],
                    config['lr_decay_continuous'],
                    inputs.generator(dither_seed, 'dither', device))
    H, W, C = spec.image
    B, S = traffic['batch'], traffic['samples']
    losses, first = [], None
    for _ in range(steps):
        idx, noise = ref.draws_train_step(spec, g, X.shape[0], B, S, device)
        xb = X[idx].to(ar.dtype).reshape(B, H, W, C)
        yb = Y[idx, 0]
        noise = [z.to(ar.dtype) for z in noise]
        if half_batch:
            xb, yb = xb[:B // 2], yb[:B // 2]
            noise = [z[:, :B // 2] for z in noise]
        with torch.enable_grad():
            loss = -ref.elbo(ar, spec, params, anchors, xb, yb, noise,
                             config['num_data'])
            grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        if first is None:
            first = {k: v.detach().double() for k, v in grads.items()}
        adam.step(params, grads)
        losses.append(float(loss.detach()))
    return losses, first, {k: p.detach().double() for k, p in params.items()}


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _scaled(values: dict, scale: dict) -> dict:
    """Per leaf value / max(the leaf's scale, the median leaf's scale); a
    non-finite result is inf."""
    median = sorted(scale.values())[len(scale) // 2]
    out = {}
    for k, v in values.items():
        x = v / max(scale[k], median, 1e-300)
        out[k] = x if math.isfinite(x) else math.inf
    return out


def training_numbers(prog, reference, p0: dict) -> dict:
    """The numbers compared of a training cell; ``prog`` and ``reference``
    are (losses, first gradients, parameters after the steps)."""
    losses, g1, p3 = prog
    rlosses, rg1, rp3 = reference
    g1, rg1, p3, rp3 = ({k: v.double().cpu() for k, v in d.items()}
                        for d in (g1, rg1, p3, rp3))
    loss_rel = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                   for a, b in zip(losses, rlosses))
    gn, rgn = _norms(g1), _norms(rg1)
    grads = _scaled({k: abs(gn[k] - rgn[k]) for k in rgn}, rgn)
    errors = _scaled(_norms({k: g1[k] - rg1[k] for k in rgn}), rgn)
    median = sorted(rgn.values())[len(rgn) // 2]
    moving = [k for k in rgn if rgn[k] >= 1e-3 * median]
    dn = _norms({k: p3[k] - p0[k].double() for k in moving})
    rdn = _norms({k: rp3[k] - p0[k].double() for k in moving})
    changes = _scaled({k: abs(dn[k] - rdn[k]) for k in moving}, rdn)
    return {'loss_rel': loss_rel, 'grad_gap': max(grads.values()),
            'change_gap': max(changes.values()),
            'grad_err_median': sorted(errors.values())[len(errors) // 2],
            'detail': {'losses': losses, 'reference_losses': rlosses,
                       'grad_leaf': max(grads, key=grads.get),
                       'change_leaf': max(changes, key=changes.get),
                       'left_out': sorted(set(rgn) - set(moving)),
                       'grad_gaps': grads, 'change_gaps': changes,
                       'grad_errors': errors}}


def reference_probabilities(ar: ref.Arith, config: dict, weights: list,
                            X, seed: int, samples: int, block: int = 32):
    """The reference's mean class probabilities [n, K] of one request X
    [n, H*W*C] (float32 rows), with the draws of a request whose
    generator is seeded with ``seed``, in blocks of rows."""
    spec = ref.Spec(config)
    H, W, C = spec.image
    params = initial_params(config, weights, ar.dtype)
    noise = ref.draws_request(spec, seed, X.shape[0], samples, X.device)
    out = []
    for r0 in range(0, X.shape[0], block):
        xb = X[r0:r0 + block].to(ar.dtype).reshape(-1, H, W, C)
        nb = [z[:, r0:r0 + block].to(ar.dtype) for z in noise]
        out.append(ref.predict_proba(ar, spec, params, xb, nb))
    return torch.cat(out)


def serving_numbers(pairs) -> dict:
    """``pairs``: [(program's probabilities, reference's)] per request."""
    gap = 0.0
    for p, r in pairs:
        d = (torch.as_tensor(p, dtype=torch.float64, device=r.device)
             - r.double()).abs().max()
        d = float(d) if torch.isfinite(d) else math.inf
        gap = max(gap, d)
    return {'prob_gap': gap, 'detail': {'requests': len(pairs)}}
