"""Plain reference of the deep convolutional GP (Blomqvist, Kaski and
Heinonen, arXiv:1810.03052; Salimbeni and Deisenroth's doubly stochastic
ELBO), written from the equations in plain PyTorch.

It imports nothing of the program under test and calls none of its
kernels.  It takes the configuration, the weights and the inputs that the
benchmark made, and it draws the Monte-Carlo noise and the minibatch
indices itself, from the seeds and in the order that the program's
documented random streams use (see ``draws_*``).

Two precisions:

* ``Arith('float64')`` -- the reference: everything in float64.
* ``Arith('tf32')`` -- the control: float32, every matrix product (and
  its backward) with both operands rounded to TF32's 10-bit mantissa, as
  the tensor cores take them, accumulated in float32.  The configurations
  state float32 with TF32 off, so TF32 is the nearest precision below.
* ``Arith('float32')`` -- plain float32, TF32 off: the precision the
  configurations state, done plainly, a witness of what float32 itself
  gives at a configuration's conditioning.

The model: hidden layers are convolutional GP layers (Z [M, L] inducing
patches shared by every patch position, R = feature maps GPs, an RBF base
kernel, a KL prior on the initial Z), the last layer an SVGP layer with
the weighted convolutional kernel k(x, x') = sum_pq w_p w_q k(x_p, x'_q)
/ P^2 over patch inducing features, and a robust-max likelihood, whose
expectation is a 20-point Gauss-Hermite quadrature.  Kuu takes a jitter
of 1e-3, a sample takes sqrt(var + 1e-3), positive parameters are stored
as softplus^-1(value - 1e-6), as the source's gpflow 1.x does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

JITTER = 1e-3
POSITIVE_MINIMUM = 1e-6
GAUSS_HERMITE_POINTS = 20
ROBUST_MAX_EPS = 1e-3
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# Float32 leaves of at least this many elements keep their Adam moments in
# bf16, stored by stochastic rounding (the program's 'auto' storage).
BF16_MOMENT_MIN_ELEMENTS = 1 << 22


# ------------------------------------------------------------ arithmetic

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (round half to
    even), as a float32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    for d, n in enumerate(shape):
        if n == 1 and g.shape[d] != 1:
            g = g.sum(d, keepdim=True)
    return g


class _TF32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        ga = g @ tf32_round(b).transpose(-1, -2)
        gb = tf32_round(a).transpose(-1, -2) @ g
        return _sum_to(ga, a.shape), _sum_to(gb, b.shape)


class Arith:
    """The precision the reference computes in."""

    def __init__(self, mode: str = 'float64'):
        if mode not in ('float64', 'float32', 'tf32'):
            raise ValueError(f'precision {mode!r}: not float64, float32 '
                             'or tf32')
        self.mode = mode
        self.dtype = torch.float64 if mode == 'float64' else torch.float32

    def mm(self, a, b):
        if self.mode == 'tf32':
            return _TF32Matmul.apply(a, b)
        return a @ b


# ----------------------------------------------------------- the model

def positive(raw: torch.Tensor) -> torch.Tensor:
    """gpflow 1.x's Log1pe: softplus(raw) + 1e-6."""
    return torch.nn.functional.softplus(raw) + POSITIVE_MINIMUM


def raw_positive(value: float) -> float:
    """Its inverse, in float64."""
    y = float(value) - POSITIVE_MINIMUM
    return y + math.log(-math.expm1(-y))


def out_size(size: int, f: int, s: int) -> int:
    return (size - f) // s + 1


def patches(X: torch.Tensor, f: int, s: int) -> torch.Tensor:
    """[N, H, W, C] -> [N, P, L]: every f x f patch with stride s (VALID),
    patches row-major over the output grid, elements row-major over
    (row, column, channel)."""
    N, _, _, C = X.shape
    u = X.unfold(1, f, s).unfold(2, f, s)           # [N, Ho, Wo, C, f, f]
    Ho, Wo = u.shape[1], u.shape[2]
    return u.permute(0, 1, 2, 4, 5, 3).reshape(N, Ho * Wo, f * f * C)


def rbf(ar: Arith, X, Z, variance, lengthscale):
    """variance * exp(-|x - z|^2 / (2 lengthscale^2)); X [..., n, L],
    Z [..., m, L] -> [..., n, m]."""
    d2 = ((X * X).sum(-1)[..., :, None] + (Z * Z).sum(-1)[..., None, :]
          - 2.0 * ar.mm(X, Z.transpose(-1, -2)))
    return variance * torch.exp(-0.5 * d2.clamp_min(0.0) / lengthscale ** 2)


def gram(ar: Arith, Z, variance, lengthscale):
    """K(Z, Z) + jitter I, on Z centred (distances do not move)."""
    Zc = Z - Z.mean(0, keepdim=True).detach()
    K = rbf(ar, Zc, Zc, variance, lengthscale)
    return K + JITTER * torch.eye(Z.shape[0], dtype=Z.dtype, device=Z.device)


def cholesky(K):
    """The lower factor of K; all NaN where K is not positive definite in
    the working precision (the control's TF32 grams can fail so)."""
    L, info = torch.linalg.cholesky_ex(K)
    return L if int(info) == 0 else torch.full_like(L, math.nan)


def conditional(ar: Arith, Kmn, Knn, Kmm, q_mu, q_sqrt):
    """Non-white SVGP marginals at n points: Kmn [M, n], Knn [n] ->
    (mean [n, R], var [n, R]), var floored at 0."""
    Lm = cholesky(Kmm)
    A = torch.linalg.solve_triangular(Lm, Kmn, upper=False)       # [M, n]
    var0 = Knn - (A * A).sum(0)
    B = torch.linalg.solve_triangular(Lm.T, A, upper=True)        # Kmm^-1 Kmn
    mean = ar.mm(B.T, q_mu)                                       # [n, R]
    Lq = torch.tril(q_sqrt)
    cols = []
    for r in range(Lq.shape[0]):
        LB = ar.mm(Lq[r].T, B)                                    # [M, n]
        cols.append(var0 + (LB * LB).sum(0))
    return mean, torch.stack(cols, 1).clamp_min(0.0)


def gauss_kl(ar: Arith, q_mu, q_sqrt, Kp):
    """KL[N(q_mu, Lq Lq^T) || N(0, Kp)] summed over the R GPs."""
    M, R = q_mu.shape
    Lp = cholesky(Kp)
    Lq = torch.tril(q_sqrt)
    X = torch.linalg.solve_triangular(Lp, Lq, upper=False)        # [R, M, M]
    alpha = torch.linalg.solve_triangular(Lp, q_mu, upper=False)
    logdet_q = torch.log(torch.diagonal(Lq, dim1=-2, dim2=-1) ** 2).sum()
    logdet_p = 2.0 * R * torch.log(torch.diagonal(Lp)).sum()
    return 0.5 * ((X * X).sum() + (alpha * alpha).sum() - M * R
                  - logdet_q + logdet_p)


def _normal_cdf(x):
    """Phi(x) squeezed into [1e-4, 1 - 1e-4], as gpflow's RobustMax."""
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0))) * (1.0 - 2e-4) + 1e-4


def _gauss_hermite(like):
    x, w = np.polynomial.hermite.hermgauss(GAUSS_HERMITE_POINTS)
    return (torch.as_tensor(x, dtype=like.dtype, device=like.device),
            torch.as_tensor(w, dtype=like.dtype, device=like.device))


def prob_is_largest(mu, var, label_onehot):
    """P(f_y >= f_j for every j) under independent N(mu, var): [..., K] ->
    [...]."""
    gx, gw = _gauss_hermite(mu)
    mu_y = (label_onehot * mu).sum(-1)
    var_y = (label_onehot * var).sum(-1)
    X = mu_y[..., None] + gx * torch.sqrt((2.0 * var_y[..., None]).clamp_min(1e-10))
    z = (X[..., None, :] - mu[..., :, None]) / torch.sqrt(
        var[..., :, None].clamp_min(1e-10))                       # [..., K, H]
    cdf = _normal_cdf(z) * (1.0 - label_onehot[..., None]) + label_onehot[..., None]
    return (cdf.prod(-2) * gw).sum(-1) / math.sqrt(math.pi)


def class_probabilities(mu, var):
    """p(y = c) for every class: [..., K] -> [..., K]."""
    K = mu.shape[-1]
    eye = torch.eye(K, dtype=mu.dtype, device=mu.device)
    p = torch.stack([prob_is_largest(mu, var, eye[c]) for c in range(K)], -1)
    return p * (1.0 - ROBUST_MAX_EPS) + (1.0 - p) * ROBUST_MAX_EPS / (K - 1)


class Spec:
    """The geometry of a configuration file."""

    def __init__(self, config: dict):
        for key, want in (('base_kernel', 'rbf'), ('last_kernel', 'conv'),
                          ('white', False), ('identity_mean', False)):
            if config[key] != want:
                raise ValueError(f'the reference models {key} = {want!r}, '
                                 f'not {config[key]!r}')
        self.image = tuple(config['image_shape'])
        self.num_classes = config['num_classes']
        self.M = list(config['M'])
        self.feature_maps = list(config['feature_maps'])
        self.filters = list(config['filter_sizes'])
        self.strides = list(config['strides'])
        H, W, C = self.image
        self.inputs = []          # (H, W, C) of each layer's input
        for i in range(len(self.M)):
            self.inputs.append((H, W, C))
            if i < len(self.feature_maps):
                f, s = self.filters[i], self.strides[i]
                H, W, C = out_size(H, f, s), out_size(W, f, s), self.feature_maps[i]

    @property
    def depth(self) -> int:
        return len(self.M)

    def patch_count(self, i: int) -> int:
        H, W, _ = self.inputs[i]
        f, s = self.filters[i], self.strides[i]
        return out_size(H, f, s) * out_size(W, f, s)

    def patch_length(self, i: int) -> int:
        return self.filters[i] ** 2 * self.inputs[i][2]

    def outputs(self, i: int) -> int:
        """Columns of layer i's output (its noise draws)."""
        if i < self.depth - 1:
            return self.patch_count(i) * self.feature_maps[i]
        return self.num_classes

    def gp_count(self, i: int) -> int:
        return self.feature_maps[i] if i < self.depth - 1 else self.num_classes

    def leaf_names(self) -> list:
        """The trainable leaves, by the names of the program's
        ``TrainState.params``."""
        out = []
        for i in range(self.depth):
            pre = f'layers.{i}.'
            if i < self.depth - 1:
                out += [pre + 'base_kernel.raw_variance',
                        pre + 'base_kernel.raw_lengthscales']
            else:
                out += [pre + 'kernel.base_kernel.raw_variance',
                        pre + 'kernel.base_kernel.raw_lengthscales',
                        pre + 'kernel.patch_weights']
            out += [pre + 'Z', pre + 'q_mu', pre + 'q_sqrt']
        return out


def _leaf(params, i, name, spec):
    pre = f'layers.{i}.'
    if name in ('raw_variance', 'raw_lengthscales'):
        mid = 'base_kernel.' if i < spec.depth - 1 else 'kernel.base_kernel.'
        return params[pre + mid + name]
    if name == 'patch_weights':
        return params[pre + 'kernel.patch_weights']
    return params[pre + name]


def layer_marginals(ar: Arith, spec: Spec, params: dict, i: int, X):
    """Layer i's marginals at the images X [n, H, W, C]: (mean [n, O_i],
    var [n, O_i])."""
    var = positive(_leaf(params, i, 'raw_variance', spec))
    ls = positive(_leaf(params, i, 'raw_lengthscales', spec))
    Z = _leaf(params, i, 'Z', spec)
    q_mu, q_sqrt = _leaf(params, i, 'q_mu', spec), _leaf(params, i, 'q_sqrt', spec)
    Kmm = gram(ar, Z, var, ls)
    f, s = spec.filters[i], spec.strides[i]
    pt = patches(X, f, s)                                          # [n, P, L]
    n, P, L = pt.shape
    if i < spec.depth - 1:
        Kmn = rbf(ar, pt.reshape(n * P, L), Z, var, ls).T          # [M, nP]
        Knn = var.expand(n * P)
        mean, v = conditional(ar, Kmn, Knn, Kmm, q_mu, q_sqrt)
        return mean.reshape(n, -1), v.reshape(n, -1)               # (P, R)
    w = _leaf(params, i, 'patch_weights', spec)
    cross = rbf(ar, pt.reshape(n * P, L), Z, var, ls).reshape(n, P, -1)
    Kzx = (cross * (w / P)[None, :, None]).sum(1)                  # [n, M]
    Kpp = rbf(ar, pt, pt, var, ls)                                 # [n, P, P]
    Knn = ((Kpp * w[:, None]).sum(1) * w).sum(1) / P ** 2
    return conditional(ar, Kzx.T, Knn, Kmm, q_mu, q_sqrt)


def propagate(ar: Arith, spec: Spec, params: dict, X, noise: list):
    """The last layer's marginals [S, n, K] of S sample paths through the
    stack, X [n, H, W, C], noise one [S, n, O_i] standard normal per layer
    (the last layer's draw is made but not read)."""
    S = noise[0].shape[0]
    n = X.shape[0]
    F = None
    for i in range(spec.depth):
        if i == 0:
            mean, var = layer_marginals(ar, spec, params, 0, X)
            mean = mean.expand(S, *mean.shape)
            var = var.expand(S, *var.shape)
        else:
            H, W, C = spec.inputs[i]
            mean, var = layer_marginals(ar, spec, params, i,
                                        F.reshape(S * n, H, W, C))
            mean, var = mean.reshape(S, n, -1), var.reshape(S, n, -1)
        if i < spec.depth - 1:
            F = mean + noise[i] * torch.sqrt(var + JITTER)
    return mean, var


def kl_total(ar: Arith, spec: Spec, params: dict, anchors: dict):
    """Sum of every layer's KL; a hidden layer's prior is Kuu of its
    initial Z (``anchors[i]``), the last layer's Kuu of its current Z."""
    total = 0.0
    for i in range(spec.depth):
        var = positive(_leaf(params, i, 'raw_variance', spec))
        ls = positive(_leaf(params, i, 'raw_lengthscales', spec))
        Z = anchors[i] if i < spec.depth - 1 else _leaf(params, i, 'Z', spec)
        total = total + gauss_kl(ar, _leaf(params, i, 'q_mu', spec),
                                 _leaf(params, i, 'q_sqrt', spec),
                                 gram(ar, Z, var, ls))
    return total


def elbo(ar: Arith, spec: Spec, params: dict, anchors: dict, X, Y, noise,
         num_data: int):
    """num_data / n * sum_n mean_s E[log p(y_n | f)] - KL, X [n, H, W, C],
    Y [n] integer labels."""
    mean, var = propagate(ar, spec, params, X, noise)
    onehot = torch.nn.functional.one_hot(Y, spec.num_classes).to(mean.dtype)
    p = prob_is_largest(mean, var, onehot.expand(mean.shape))
    K = spec.num_classes
    ve = p * math.log(1.0 - ROBUST_MAX_EPS) + (1.0 - p) * math.log(
        ROBUST_MAX_EPS / (K - 1))
    return num_data / X.shape[0] * ve.mean(0).sum() - kl_total(
        ar, spec, params, anchors)


@torch.no_grad()
def predict_proba(ar: Arith, spec: Spec, params: dict, X, noise):
    """Mean class probabilities [n, K] over the S sample paths."""
    mean, var = propagate(ar, spec, params, X, noise)
    return class_probabilities(mean, var).mean(0)


# -------------------------------------------------------------- the draws

def draws_train_step(spec: Spec, generator, num_data, batch, samples, device):
    """One step's draws from the training stream: the batch's indices
    (uniform, with replacement), then one [S, B, O_i] normal per layer."""
    idx = torch.randint(0, num_data, (batch,), generator=generator,
                        device=device)
    noise = [torch.randn((samples, batch, spec.outputs(i)),
                         generator=generator, device=device,
                         dtype=torch.float32) for i in range(spec.depth)]
    return idx, noise


def draws_request(spec: Spec, seed: int, rows: int, samples: int, device):
    """A request's draws: one [S, n, O_i] normal per layer from a
    generator seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.randn((samples, rows, spec.outputs(i)), generator=g,
                        device=device, dtype=torch.float32)
            for i in range(spec.depth)]


# ---------------------------------------------------------- the optimizer

def learning_rate(lr0: float, decay_steps: int, step: int,
                  continuous: bool) -> float:
    """x0.1 every ``decay_steps``: in steps, or continuously."""
    return lr0 * 0.1 ** (step / decay_steps if continuous
                         else step // decay_steps)


def sr_bf16(x: torch.Tensor, generator) -> torch.Tensor:
    """x rounded to bf16 by stochastic rounding (a uniform 16-bit dither
    added below the cut), returned in x's dtype."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64)
    dither = torch.randint(0, 1 << 16, u.shape, generator=generator,
                           device=u.device)
    u = ((u & 0xFFFFFFFF) + dither) & 0xFFFF0000
    u = torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)
    return u.view(torch.float32).to(x.dtype)


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) with the
    program's moment storage: bf16 by stochastic rounding for float32
    leaves of 2^22 elements or more."""

    def __init__(self, params: dict, lr: float, decay_steps: int,
                 continuous: bool, generator, stored_dtype=torch.float32):
        self.lr, self.decay_steps = lr, decay_steps
        self.continuous = continuous
        self.generator = generator
        self.bf16 = {k: stored_dtype == torch.float32
                     and p.numel() >= BF16_MOMENT_MIN_ELEMENTS
                     for k, p in params.items()}
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        lr = learning_rate(self.lr, self.decay_steps, self.count,
                           self.continuous)
        self.count += 1
        c1 = 1.0 - ADAM_B1 ** self.count
        c2 = 1.0 - ADAM_B2 ** self.count
        for k, g in grads.items():
            m = ADAM_B1 * self.m[k] + (1.0 - ADAM_B1) * g
            v = ADAM_B2 * self.v[k] + (1.0 - ADAM_B2) * g * g
            params[k] -= lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
            if self.bf16[k]:
                m, v = sr_bf16(m, self.generator), sr_bf16(v, self.generator)
            self.m[k], self.v[k] = m, v
