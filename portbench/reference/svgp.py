"""Plain reference of the single-layer SVGP with an ARD RBF kernel over the
flattened image, trained by natural gradients on (q_mu, q_sqrt) and Adam
on the rest, written from the equations in plain PyTorch.

The model is the reference DeepCGP's builder with ``--last-kernel rbf``
(kekeblom/DeepCGP ``conv_gp/models.py:142-198``): one SVGP layer, R = 10
latent GPs sharing the kernel k(x, z) = variance * exp(-sum_d (x_d -
z_d)^2 / (2 l_d^2)) over the D flattened pixels, inducing points Z [M, D],
a non-whitened q(u) = N(q_mu, Lq Lq^T) per GP and a robust-max likelihood
(a 20-point Gauss-Hermite quadrature, ``reference/convgp.py``).  The
training wiring is the source's NatGrad experiment
(``conv_gp/experiment.py:90-108``): a natural-gradient step on (q_mu,
q_sqrt) in the natural parameters (gpflow's ``NatGradOptimizer`` with
``XiNat``; Salimbeni, Eleftheriadis and Hensman, arXiv:1803.09151) and an
Adam step on Z, the variance and the lengthscales, both from one
gradient.

The natural-gradient step is the textbook round trip, computed as it is
written: the expectation parameters eta = (mu, S + mu mu^T); dL/deta by
autograd through the map eta -> (mu, chol(eta2 - eta1 eta1^T)); the
natural parameters theta = (S^-1 mu, -1/2 S^-1) moved to theta - gamma
dL/deta; and back to (mu = S theta1, chol S) with S = (-2 theta2)^-1.

It imports nothing of the program under test and calls none of its
kernels.  It takes the weights and the inputs the benchmark made, and
draws the minibatch indices and the Monte-Carlo noise itself, from the
seed and in the order of the program's documented training stream (see
:func:`draws`).

Departures from the source, each as the program under test has it:

* the step size gamma follows the schedule min((step / 100 * 1e-3 +
  gamma0) * 0.2^steps_back, 1), and a step whose loss, gradient or
  proposal is not finite commits nothing and backs gamma off
  (``steps_back`` + 1); a non-finite loss also rolls the parameters back
  to the last ones whose loss was seen finite, and each chunk of steps
  ends with one more ELBO on a fresh minibatch that verifies the last
  commit (the source retries a failed Cholesky by hand);
* Adam's learning rate is read at the global step (failed steps
  included), its bias corrections at the count of committed steps; the
  moments are kept in the working precision;
* the minibatch is drawn uniformly with replacement by the program's
  stream, not by the source's shuffled epochs;
* the S Monte-Carlo samples of the single layer's marginals are S
  copies of the same marginals (the doubly stochastic ELBO tiles them: a
  one-layer model has nothing to sample through), and the draws of the
  layer's noise are made and not read.

Precisions: ``convgp.Arith`` ('float64' the reference, 'tf32' the
control, 'float32' plain).  TF32 is off for every product that is not
the control's own rounding.
"""

from __future__ import annotations

import math

import torch

from .convgp import (ADAM_B1, ADAM_B2, ADAM_EPS, JITTER, ROBUST_MAX_EPS,
                     Arith, gauss_kl, learning_rate, positive,
                     prob_is_largest, raw_positive)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VARIANCE = 'layers.0.kernel.raw_variance'
LENGTHSCALES = 'layers.0.kernel.raw_lengthscales'
Z_LEAF = 'layers.0.Z'
Q_MU = 'layers.0.q_mu'
Q_SQRT = 'layers.0.q_sqrt'
# The trainable leaves, by the names of the program's ``TrainState.params``.
LEAVES = (VARIANCE, LENGTHSCALES, Z_LEAF, Q_MU, Q_SQRT)
NATGRAD_LEAVES = (Q_MU, Q_SQRT)
ADAM_LEAVES = (VARIANCE, LENGTHSCALES, Z_LEAF)


# ----------------------------------------------------------- the model

def rbf_ard(ar: Arith, X, Z, variance, lengthscales):
    """variance * exp(-|x / l - z / l|^2 / 2): X [n, D], Z [m, D] ->
    [n, m]."""
    Xs, Zs = X / lengthscales, Z / lengthscales
    d2 = ((Xs * Xs).sum(-1)[:, None] + (Zs * Zs).sum(-1)[None, :]
          - 2.0 * ar.mm(Xs, Zs.T))
    return variance * torch.exp(-0.5 * d2.clamp_min(0.0))


def kuu(ar: Arith, Z, variance, lengthscales):
    """K(Z, Z) + jitter I, on Z centred (distances do not move)."""
    Zc = Z - Z.mean(0, keepdim=True).detach()
    K = rbf_ard(ar, Zc, Zc, variance, lengthscales)
    return K + JITTER * torch.eye(Z.shape[0], dtype=Z.dtype, device=Z.device)


def cholesky(K):
    """The lower factor of each matrix of K; NaN where one is not
    positive definite in the working precision."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, math.nan)


def marginals(ar: Arith, params: dict, X):
    """(mean [n, R], var [n, R]) of q(f) at the rows X [n, D]: the
    non-whitened SVGP conditional, var floored at 0."""
    variance = positive(params[VARIANCE])
    ls = positive(params[LENGTHSCALES])
    Z, q_mu = params[Z_LEAF], params[Q_MU]
    Lm = cholesky(kuu(ar, Z, variance, ls))
    Kmn = rbf_ard(ar, Z, X, variance, ls)                         # [M, n]
    A = torch.linalg.solve_triangular(Lm, Kmn, upper=False)
    B = torch.linalg.solve_triangular(Lm.T, A, upper=True)        # Kmm^-1 Kmn
    var0 = variance - (A * A).sum(0)
    mean = ar.mm(B.T, q_mu)
    Lq = torch.tril(params[Q_SQRT])
    cols = [var0 + (ar.mm(Lq[r].T, B) ** 2).sum(0) for r in range(Lq.shape[0])]
    return mean, torch.stack(cols, 1).clamp_min(0.0)


def kl(ar: Arith, params: dict):
    """KL[q(u) || p(u)], p(u) = N(0, Kuu of the current Z), summed over
    the R GPs."""
    variance = positive(params[VARIANCE])
    ls = positive(params[LENGTHSCALES])
    return gauss_kl(ar, params[Q_MU], params[Q_SQRT],
                    kuu(ar, params[Z_LEAF], variance, ls))


def elbo(ar: Arith, params: dict, X, Y, num_data: int, samples: int):
    """num_data / n * sum_n mean_s E[log p(y_n | f)] - KL: X [n, D], Y [n]
    integer labels, the marginals tiled over the S samples."""
    mean, var = marginals(ar, params, X)
    mean = mean.expand(samples, *mean.shape)
    var = var.expand(samples, *var.shape)
    K = mean.shape[-1]
    onehot = torch.nn.functional.one_hot(Y, K).to(mean.dtype)
    p = prob_is_largest(mean, var, onehot.expand(mean.shape))
    ve = p * math.log(1.0 - ROBUST_MAX_EPS) + (1.0 - p) * math.log(
        ROBUST_MAX_EPS / (K - 1))
    return num_data / X.shape[0] * ve.mean(0).sum() - kl(ar, params)


def loss_and_grads(ar: Arith, params: dict, X, Y, num_data, samples):
    """(-ELBO, {leaf: its gradient}) by autograd."""
    with torch.enable_grad():
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = -elbo(ar, leaves, X, Y, num_data, samples)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


# -------------------------------------------------- the natural gradient

def natgrad_step(ar: Arith, q_mu, q_sqrt, dq_mu, dq_sqrt, gamma: float):
    """One natural-gradient step of every GP's q(u) = N(mu, Lq Lq^T): q_mu
    [M, R], q_sqrt [R, M, M] (lower triangle used), their loss gradients
    d*.  The textbook round trip through the expectation and the natural
    parameters; returns the proposed (q_mu [M, R], q_sqrt [R, M, M]),
    NaN where the new covariance is not positive definite."""
    mu = q_mu.T                                                   # [R, M]
    Lq = torch.tril(q_sqrt)
    S = ar.mm(Lq, Lq.transpose(-1, -2))
    outer = mu[:, :, None] * mu[:, None, :]
    with torch.enable_grad():
        eta1 = mu.detach().clone().requires_grad_(True)
        eta2 = (S + outer).detach().requires_grad_(True)
        L, info = torch.linalg.cholesky_ex(
            eta2 - eta1[:, :, None] * eta1[:, None, :])
        d_eta1, d_eta2 = torch.autograd.grad(
            [eta1, L], [eta1, eta2], [dq_mu.T, torch.tril(dq_sqrt)])
    d_eta2 = torch.where((info == 0)[:, None, None], d_eta2, math.nan)
    S_inv = torch.cholesky_inverse(Lq)
    theta1 = ar.mm(S_inv, mu[:, :, None])[..., 0] - gamma * d_eta1
    theta2 = -0.5 * S_inv - gamma * d_eta2
    S_new, info = torch.linalg.inv_ex(-2.0 * theta2)
    S_new = 0.5 * (S_new + S_new.transpose(-1, -2))
    S_new = torch.where((info == 0)[:, None, None], S_new, math.nan)
    mu_new = ar.mm(S_new, theta1[:, :, None])[..., 0]
    return mu_new.T, cholesky(S_new)


def gamma_schedule(step: int, steps_back: int, gamma0: float) -> float:
    """min((step / 100 * 1e-3 + gamma0) * 0.2^steps_back, 1)."""
    return min((step / 100.0 * 1e-3 + gamma0) * 0.2 ** steps_back, 1.0)


# -------------------------------------------------------------- the draws

def draws(generator, num_data: int, batch: int, samples: int,
          outputs: int, dtype, device):
    """One step's draws from the training stream: the batch's indices
    (uniform, with replacement), then the layer's [S, B, R] normals in the
    program's dtype (made, and not read by a one-layer ELBO).  A chunk's
    final check draws the same again."""
    idx = torch.randint(0, num_data, (batch,), generator=generator,
                        device=device)
    noise = torch.randn((samples, batch, outputs), generator=generator,
                        dtype=dtype, device=device)
    return idx, noise


# ---------------------------------------------------------- the training

class Trainer:
    """The reference's training state and its steps: NatGrad on (q_mu,
    q_sqrt), Adam on the rest, the commit guard, the backoff and the
    rollback to the last verified parameters.

    ``params`` {leaf: tensor} in ``ar``'s precision; ``generator`` the
    training stream; ``noise_dtype`` the dtype of the program's noise
    draws.  Planted faults for the calibration: ``half_batch`` (half of
    each batch left out, the mean taken over the rest), ``natgrad=False``
    (the natural-gradient half skipped: q_mu and q_sqrt stay as they are),
    ``gamma_scale`` (gamma multiplied)."""

    def __init__(self, ar: Arith, params: dict, config: dict, traffic: dict,
                 generator, noise_dtype=torch.float32, half_batch=False,
                 natgrad=True, gamma_scale=1.0):
        self.ar, self.config, self.traffic = ar, config, traffic
        self.params = {k: params[k].to(ar.dtype).clone() for k in LEAVES}
        self.prev = {k: p.clone() for k, p in self.params.items()}
        self.m = {k: torch.zeros_like(self.params[k]) for k in ADAM_LEAVES}
        self.v = {k: torch.zeros_like(self.params[k]) for k in ADAM_LEAVES}
        self.count = self.step_count = self.steps_back = 0
        self.generator, self.noise_dtype = generator, noise_dtype
        self.half_batch, self.natgrad = half_batch, natgrad
        self.gamma_scale = gamma_scale

    def _batch(self, X, Y):
        B, S = self.traffic['batch'], self.traffic['samples']
        idx, _ = draws(self.generator, X.shape[0], B, S,
                       self.config['num_classes'], self.noise_dtype,
                       X.device)
        xb, yb = X[idx].to(self.ar.dtype), Y[idx, 0]
        if self.half_batch:
            xb, yb = xb[:B // 2], yb[:B // 2]
        return xb, yb

    def _elbo_args(self):
        return self.config['num_data'], self.traffic['samples']

    @torch.no_grad()
    def step(self, X, Y):
        """One optimizer step on a fresh minibatch: (loss, gradients)."""
        xb, yb = self._batch(X, Y)
        loss, grads = loss_and_grads(self.ar, self.params, xb, yb,
                                     *self._elbo_args())
        loss_ok = bool(torch.isfinite(loss))
        new = {}
        ok = loss_ok and all(bool(torch.isfinite(grads[k]).all())
                             for k in ADAM_LEAVES)
        if self.natgrad:
            gamma = self.gamma_scale * gamma_schedule(
                self.step_count, self.steps_back, self.config['gamma'])
            new[Q_MU], new[Q_SQRT] = natgrad_step(
                self.ar, self.params[Q_MU], self.params[Q_SQRT],
                grads[Q_MU], grads[Q_SQRT], gamma)
            ok = ok and all(bool(torch.isfinite(new[k]).all())
                            for k in NATGRAD_LEAVES)
        else:
            new[Q_MU], new[Q_SQRT] = self.params[Q_MU], self.params[Q_SQRT]
        lr = learning_rate(self.config['lr'], self.config['lr_decay_steps'],
                           self.step_count, self.config['lr_decay_continuous'])
        count = self.count + 1
        c1, c2 = 1.0 - ADAM_B1 ** count, 1.0 - ADAM_B2 ** count
        m, v = {}, {}
        for k in ADAM_LEAVES:
            g = grads[k]
            m[k] = ADAM_B1 * self.m[k] + (1.0 - ADAM_B1) * g
            v[k] = ADAM_B2 * self.v[k] + (1.0 - ADAM_B2) * g * g
            new[k] = self.params[k] - lr * (m[k] / c1) / (
                torch.sqrt(v[k] / c2) + ADAM_EPS)
        if ok:
            self.m, self.v, self.count = m, v, count
        else:
            self.steps_back += 1
        for k in LEAVES:
            verified = self.params[k] if loss_ok else self.prev[k]
            self.prev[k] = verified
            self.params[k] = new[k] if ok else verified
        self.step_count += 1
        return loss, grads

    @torch.no_grad()
    def final_check(self, X, Y):
        """The ELBO on a fresh minibatch; a non-finite one rolls back to
        the last verified parameters."""
        xb, yb = self._batch(X, Y)
        if not bool(torch.isfinite(elbo(self.ar, self.params, xb, yb,
                                        *self._elbo_args()))):
            self.params = {k: p.clone() for k, p in self.prev.items()}

    def chunk(self, X, Y, steps: int) -> list:
        """``steps`` steps and the chunk's final check: the losses."""
        losses = [self.step(X, Y)[0] for _ in range(steps)]
        self.final_check(X, Y)
        return losses


def initial_params(weights: dict, dtype=torch.float32) -> dict:
    """The trainable leaves, by the program's names, from the weights
    (Z [M, D], q_mu [M, R], q_sqrt [R, M, M], variance, lengthscales
    [D]): positive parameters stored raw as float32 values, as the
    program's float32 leaves hold them."""
    device = weights['Z'].device
    ls = weights['lengthscales'].double().cpu()
    raw_ls = torch.tensor([raw_positive(float(x)) for x in ls],
                          dtype=torch.float32, device=device)
    raw_var = torch.tensor(raw_positive(weights['variance']),
                           dtype=torch.float32, device=device)
    return {VARIANCE: raw_var.to(dtype), LENGTHSCALES: raw_ls.to(dtype),
            Z_LEAF: weights['Z'].to(dtype), Q_MU: weights['q_mu'].to(dtype),
            Q_SQRT: weights['q_sqrt'].to(dtype)}
