"""Optimizer pieces of the Adam path (counterpart of the Adam half of
``deepcgp_tpu/training/optim.py``): the reference's learning-rate schedule
and Adam in the form of optax ``scale_by_adam``.

Every function here takes and returns tensors on the parameters' device,
so a chunk of steps runs without a host sync.  NatGrad is not ported yet
(ROADMAP queue A3).
"""

from __future__ import annotations

import torch

# Leaves from this size on get bf16 stochastic-rounding moments under the
# JAX package's default 'auto' storage; the port has no such store yet.
AUTO_BF16_MIN_ELEMENTS = 1 << 22
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def learning_rate_schedule(lr: float, lr_decay_steps: int,
                           staircase: bool = True):
    """x0.1 exponential decay every ``lr_decay_steps`` (optax
    ``exponential_decay``): ``staircase=True`` is the reference's current
    source, ``False`` the continuous decay its committed result runs
    were trained with.  The schedule maps a step tensor to an lr tensor."""
    def schedule(step: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        t = step.to(dtype) / lr_decay_steps
        if staircase:
            t = torch.floor(t)
        return lr * torch.pow(torch.full_like(t, 0.1), t)
    return schedule


def check_moment_storage(name: str, p: torch.Tensor) -> None:
    """The JAX package's default 'auto' moment storage keeps exact moments
    in the parameter's dtype below 2^22 elements and bf16 moments with
    stochastic rounding from there on (its M=1024 configurations).  The
    bf16 store is not ported yet, so such a leaf raises instead of being
    stored in float32."""
    if p.dtype == torch.float32 and p.numel() >= AUTO_BF16_MIN_ELEMENTS:
        raise NotImplementedError(
            f'{name} has {p.numel()} elements: its Adam moments would be '
            'stored in bf16 with stochastic rounding, which comes with the '
            'M=1024 slice (ROADMAP queue A4)')


def adam_init(params: dict) -> dict:
    """{'count': 0, 'mu': zeros, 'nu': zeros} for {name: parameter}."""
    for name, p in params.items():
        check_moment_storage(name, p)
    device = next(iter(params.values())).device
    return {'count': torch.zeros((), dtype=torch.int64, device=device),
            'mu': {k: torch.zeros_like(p) for k, p in params.items()},
            'nu': {k: torch.zeros_like(p) for k, p in params.items()}}


def adam_updates(grads: dict, state: dict):
    """optax ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, no eps_root):
    (updates, proposed moments, proposed count).  Nothing is written: the
    trainer commits the proposals only when the step is finite."""
    count = state['count'] + 1
    updates, mu, nu = {}, {}, {}
    for k, g in grads.items():
        c = count.to(g.dtype)
        c1 = 1.0 - torch.pow(torch.full_like(c, ADAM_B1), c)
        c2 = 1.0 - torch.pow(torch.full_like(c, ADAM_B2), c)
        m = ADAM_B1 * state['mu'][k] + (1.0 - ADAM_B1) * g
        v = ADAM_B2 * state['nu'][k] + (1.0 - ADAM_B2) * g.square()
        updates[k] = (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
        mu[k], nu[k] = m, v
    return updates, mu, nu, count
