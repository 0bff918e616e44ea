"""Training loop, Adam path (counterpart of
``deepcgp_tpu/training/trainer.py``).

``run_chunk`` runs a number of optimizer steps with no host sync: each
step draws its minibatch on the device (uniform, with replacement, from
the state's generator) and its Monte-Carlo noise from the same generator,
and the commit guard is a ``torch.where`` on a device boolean.  A step
whose loss or any gradient is non-finite leaves parameters and Adam
moments as they were (the reference's Cholesky-failure retry); the
failure stays visible as a NaN in the returned ELBO trace.

The trainable set is ``model.parameters()``: the layers' raw kernel
parameters, Z, q_mu, q_sqrt and the patch weights.  The KL anchors Z0 are
buffers, outside it by construction, as the JAX package's
``trainable_mask`` leaves them out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deepcgp_tpu_torch.training import optim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = 'Adam'
    lr: float = 0.01
    lr_decay_steps: int = 100000
    batch_size: int = 32
    # True = the reference's current source; False = the continuous decay
    # its committed result artifacts were trained with.
    lr_staircase: bool = True


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    params: dict             # {name: parameter}, the trainable set
    opt_state: dict          # Adam: count, mu, nu; SGD: {}
    step: torch.Tensor       # global optimizer step, int64 on the device
    generator: torch.Generator


def init_state(model, config: TrainConfig, seed: int = 0,
               global_step: int = 0) -> TrainState:
    """Switch gradients on for the trainable set and start the optimizer.
    Minibatches and Monte-Carlo noise come from a generator on the model's
    device seeded with ``seed``."""
    if config.optimizer == 'NatGrad':
        raise NotImplementedError('NatGrad comes with its own slice '
                                  '(ROADMAP queue A3)')
    if config.optimizer not in ('Adam', 'SGD'):
        raise ValueError('Not a supported optimizer. Try Adam or SGD.')
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    device = next(iter(params.values())).device
    opt_state = optim.adam_init(params) if config.optimizer == 'Adam' else {}
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return TrainState(model=model, params=params, opt_state=opt_state,
                      step=torch.full((), global_step, dtype=torch.int64,
                                      device=device),
                      generator=generator)


def loss_and_grads(state: TrainState, xb, yb, noise=None):
    """(-ELBO, {name: gradient}) at the current parameters; the MC noise
    is ``noise`` (one [S, B, O_l] tensor per layer) or drawn from the
    state's generator."""
    draw = {'noise': noise} if noise is not None else {'generator': state.generator}
    with torch.enable_grad():
        loss = -state.model.elbo(xb, yb, **draw)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names],
                                    allow_unused=True)
    return loss.detach(), {
        k: (torch.zeros_like(state.params[k]) if g is None else g)
        for k, g in zip(names, grads)}


def train_step(state: TrainState, config: TrainConfig, xb, yb, noise=None):
    """One optimizer iteration on the batch (xb [B, D], yb [B, 1]); updates
    ``state`` in place and returns the ELBO (a device scalar)."""
    loss, grads = loss_and_grads(state, xb, yb, noise)
    ok = torch.isfinite(loss)
    for g in grads.values():
        ok = ok & torch.isfinite(g).all()
    dtype = loss.dtype
    lr = optim.learning_rate_schedule(config.lr, config.lr_decay_steps,
                                      config.lr_staircase)(state.step, dtype)
    with torch.no_grad():
        if config.optimizer == 'SGD':
            updates = grads
        else:
            updates, mu, nu, count = optim.adam_updates(grads, state.opt_state)
            for k in grads:
                state.opt_state['mu'][k].copy_(
                    torch.where(ok, mu[k], state.opt_state['mu'][k]))
                state.opt_state['nu'][k].copy_(
                    torch.where(ok, nu[k], state.opt_state['nu'][k]))
            state.opt_state['count'] = torch.where(ok, count,
                                                   state.opt_state['count'])
        for k, p in state.params.items():
            p.copy_(torch.where(ok, p - lr.to(p.dtype) * updates[k], p))
    state.step = state.step + 1
    return -loss


def run_chunk(state: TrainState, config: TrainConfig, X_train: torch.Tensor,
              Y_train: torch.Tensor, num_steps: int) -> torch.Tensor:
    """``num_steps`` optimizer iterations on minibatches drawn uniformly,
    with replacement, from X_train [N, D] and Y_train [N, 1] (both on the
    model's device).  Returns the ELBO trace [num_steps] on the device."""
    N = X_train.shape[0]
    elbos = []
    for _ in range(num_steps):
        idx = torch.randint(0, N, (config.batch_size,),
                            generator=state.generator, device=X_train.device)
        elbos.append(train_step(state, config, X_train[idx], Y_train[idx]))
    return torch.stack(elbos)


@torch.no_grad()
def accuracy(model, X_test, Y_test, seed: int = 0, batch_size: int = 32,
             num_samples: int = 5) -> float:
    """Test accuracy: per batch of ``batch_size``, the mean class
    probability over ``num_samples`` MC draws, argmax, fraction correct."""
    device = model.layers[0].Z.device
    dtype = model.layers[0].Z.dtype
    X = torch.as_tensor(np.asarray(X_test).reshape(len(X_test), -1),
                        dtype=dtype, device=device)
    Y = torch.as_tensor(np.asarray(Y_test).reshape(-1, 1), device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    correct = torch.zeros((), dtype=torch.int64, device=device)
    for start in range(0, X.shape[0], batch_size):
        probs, _ = model.predict_y(X[start:start + batch_size], num_samples,
                                   generator=g)
        pred = probs.mean(0).argmax(1)
        correct += (pred[:, None] == Y[start:start + batch_size]).sum()
    return float(correct) / Y.numel()
