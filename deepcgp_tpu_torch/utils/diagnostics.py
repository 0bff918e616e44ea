"""Numerics diagnostics (counterpart of ``deepcgp_tpu/utils/diagnostics.py``).

The card computes in float32, so the port ships the JAX package's checks:

* ``elbo_drift`` -- the same model and batch in float32 (on the model's
  device) and float64 (on the CPU), on the same draws: the relative ELBO
  drift;
* ``param_health`` -- non-finite counts per leaf (NatGrad failure
  forensics);
* ``cholesky_health`` -- per layer, does chol(Kuu) succeed under the
  current jitter.
"""

from __future__ import annotations

import copy

import torch

from deepcgp_tpu_torch.training.optim import jax_keystr, jax_leaf_order


def cast_model(model, dtype, device=None):
    """A copy of the model with every floating parameter and buffer cast to
    ``dtype`` (and moved to ``device`` when given); the model itself is
    left as it is."""
    out = copy.deepcopy(model)
    if device is not None:
        out = out.to(device)
    return out.to(dtype)


def elbo_drift(model, X, Y, *, noise=None, seed: int = 0,
               num_samples: int | None = None) -> dict:
    """Relative |ELBO_f32 - ELBO_f64| / |ELBO_f64| on one batch (X [N, D],
    Y [N, 1], arrays or tensors).  The float64 copy runs on the CPU, the
    float32 one on the model's device; both take ``noise`` (one
    [S, N, O_l] standard-normal array per layer, as ``DGP.elbo`` takes it;
    drawn in float64 on the CPU from ``seed`` when not given).
    ``num_samples`` overrides the model's S.  Returns {'elbo_f32',
    'elbo_f64', 'rel_drift'}."""
    device = model.layers[0].Z.device
    X64 = torch.as_tensor(X, dtype=torch.float64).reshape(len(X), -1)
    Y = torch.as_tensor(Y)
    S = num_samples or model.num_samples
    if noise is None:
        g = torch.Generator().manual_seed(seed)
        noise = [torch.randn((S, X64.shape[0], layer.num_outputs),
                             generator=g, dtype=torch.float64)
                 for layer in model.layers]
    with torch.no_grad():
        m64 = cast_model(model, torch.float64, 'cpu')
        m64.num_samples = S
        e64 = float(m64.elbo(X64, Y, noise=noise))
        m32 = cast_model(model, torch.float32)
        m32.num_samples = S
        e32 = float(m32.elbo(X64.to(device, torch.float32), Y.to(device),
                             noise=[torch.as_tensor(z).float() for z in noise]))
    rel = abs(e32 - e64) / max(abs(e64), 1e-12)
    return {'elbo_f32': e32, 'elbo_f64': e64, 'rel_drift': rel}


def param_health(model) -> dict:
    """{JAX key path: non-finite count} for every floating leaf with any
    NaN or Inf (the JAX package's keys, '.layers[0].q_sqrt')."""
    bad = {}
    for name, t in jax_leaf_order(model):
        if not t.is_floating_point():
            continue
        n = int((~torch.isfinite(t)).sum())
        if n:
            bad[jax_keystr(name)] = n
    return bad


@torch.no_grad()
def cholesky_health(model) -> list:
    """Per layer: is chol(Kuu) finite under the current jitter (a failed
    factorization is NaN, as in the JAX package)?"""
    return [{'layer': i,
             'cholesky_ok': bool(torch.isfinite(layer.precompute().Lm).all())}
            for i, layer in enumerate(model.layers)]
