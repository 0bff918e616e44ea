"""Optimizers (counterpart of ``deepcgp_tpu/training/optim.py``): the
reference's learning-rate and gamma schedules, Adam in the form of optax
``scale_by_adam`` with the JAX package's 'auto' moment storage, and the
natural-gradient step on the variational parameters.

Every function here takes and returns tensors on the parameters' device,
so a chunk of steps runs without a host sync.

The natural gradient follows Salimbeni, Eleftheriadis & Hensman (2018):
a step in the natural parameters theta = (S^-1 mu, -1/2 S^-1) along
dL/deta, eta = (mu, S + mu mu^T).  :func:`natgrad_update` is the fused
form the trainer runs; :func:`natgrad_update_theta` the explicit round trip
it is held against.  Every product whose result is the new variational
state runs in full float32 (TF32 is off, ``config``): the JAX package's
``Precision.HIGHEST``.
"""

from __future__ import annotations

import torch

from deepcgp_tpu_torch.ops import cuda_linalg, linalg
from deepcgp_tpu_torch.utils import profiling

# Leaves from this size on get bf16 stochastic-rounding moments under the
# JAX package's default 'auto' storage.
AUTO_BF16_MIN_ELEMENTS = 1 << 22
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_U32 = 0xFFFFFFFF

# ----------------------------------------------------------------- schedules


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


def gamma_schedule(step: torch.Tensor, steps_back: torch.Tensor,
                   gamma0: float) -> torch.Tensor:
    """NatGrad step size min((step/100 * 1e-3 + gamma0) * 0.2^steps_back, 1)
    (the reference's schedule), in the dtype of ``steps_back``."""
    t = step.to(steps_back.dtype) / 100.0
    return torch.clamp_max((t * 1e-3 + gamma0) * torch.pow(0.2, steps_back),
                           1.0)


# ------------------------------------------------- Adam with bf16 moments


def _sr_to_bf16(x: torch.Tensor, salt: torch.Tensor | int) -> torch.Tensor:
    """float32 -> bf16 by stochastic rounding, bit for bit the JAX
    package's ``_sr_to_bf16``: a 16-bit dither from a murmur-style hash of
    (flat index, salt) is added to the float's bit pattern and the low 16
    bits are cut.  Exact values stay exact; non-finite inputs stay
    non-finite.  The uint32 arithmetic runs in int64 masked to 32 bits
    (torch has no logical right shift on int32)."""
    if x.dtype != torch.float32:
        raise TypeError(f'_sr_to_bf16: float32 only, got {x.dtype}')
    u = x.contiguous().view(torch.int32).to(torch.int64) & _U32
    h = torch.arange(x.numel(), dtype=torch.int64,
                     device=x.device).reshape(x.shape)
    h = (h * 2654435761 + salt) & _U32
    h ^= h >> 15
    h = (h * 0x2C1B3C6D) & _U32
    h ^= h >> 12
    h = (h * 0x297A2D39) & _U32
    h ^= h >> 15
    u = (u + (h & 0xFFFF)) & 0xFFFF0000
    u = torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)
    return u.view(torch.float32).to(torch.bfloat16)


def bf16_moments(p: torch.Tensor) -> bool:
    """'auto' storage: bf16 moments for float32 leaves of >= 2^22 elements
    (the bandwidth-bound M=1024 q_sqrt stacks), exact moments in the
    parameter's dtype for every other leaf."""
    return p.dtype == torch.float32 and p.numel() >= AUTO_BF16_MIN_ELEMENTS


# Field order of the JAX package's pytree nodes, by the port's class name:
# the order in which its tree_map visits leaves, and so numbers the bf16
# moment leaves (each one's dither salt).
_JAX_FIELDS = {
    'DGP': ('layers', 'likelihood'),
    'ConvLayer': ('base_kernel', 'Z', 'q_mu', 'q_sqrt', 'Z0', 'mean_function'),
    'SVGPLayer': ('kernel', 'Z', 'q_mu', 'q_sqrt'),
    'ConvKernel': ('base_kernel', 'patch_weights'),
    'AdditivePatchKernel': ('base_kernel', 'patch_weights'),
    'RBF': ('raw_variance', 'raw_lengthscales'),
    'ArcCosine': ('raw_variance', 'raw_weight_variances', 'raw_bias_variance'),
    'Conv2dMean': ('conv_filter',),
    'PatchwiseConv2d': ('conv_filter',),
    'Gaussian': ('raw_variance',),
}


def jax_leaf_order(model) -> list:
    """[(name, tensor)] of the model's parameters and buffers in the JAX
    package's pytree order, named as ``named_parameters`` names them."""
    out = []

    def walk(prefix, node):
        if isinstance(node, torch.Tensor):
            out.append((prefix, node))
        elif isinstance(node, torch.nn.ModuleList):
            for i, m in enumerate(node):
                walk(f'{prefix}.{i}', m)
        else:
            for field in _JAX_FIELDS.get(type(node).__name__, ()):
                walk(f'{prefix}.{field}' if prefix else field,
                     getattr(node, field))

    walk('', model)
    missing = set(dict(model.named_parameters())) - {n for n, _ in out}
    if missing:
        raise ValueError(f'jax_leaf_order: no JAX field order for {missing}')
    return out


def jax_keystr(name: str) -> str:
    """The JAX package's key path of the leaf a port name names:
    'layers.0.base_kernel.raw_variance' -> '.layers[0].base_kernel.raw_variance'
    (``''.join(str(k) for k in path)`` of ``tree_flatten_with_path``)."""
    return ''.join(f'[{p}]' if p.isdigit() else f'.{p}'
                   for p in name.split('.'))


def bf16_leaf_order(model) -> list:
    """Names of the leaves the JAX package stores with bf16 moments, in the
    order it numbers them -- every such leaf of its model, also those
    outside this optimizer's set (Z0, and q_mu/q_sqrt under NatGrad)."""
    return [n for n, t in jax_leaf_order(model) if bf16_moments(t)]


def adam_init(params: dict, bf16_order: list | None = None) -> dict:
    """Adam state for {name: parameter}: 'count', the moments 'mu' and
    'nu' (bf16 for the leaves :func:`bf16_moments` picks, else the
    parameter's dtype), and 'salt_index' {name: k} numbering the bf16
    leaves as ``bf16_order`` lists them (default: the order of
    ``params``)."""
    big = [k for k, p in params.items() if bf16_moments(p)]
    order = big if bf16_order is None else list(bf16_order)
    if set(big) - set(order):
        raise ValueError(f'adam_init: bf16 leaves {set(big) - set(order)} '
                         'are not in bf16_order')

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.bfloat16 if bf16_moments(p)
                                else p.dtype)
    device = next(iter(params.values())).device
    return {'count': torch.zeros((), dtype=torch.int64, device=device),
            'mu': {k: zeros(p) for k, p in params.items()},
            'nu': {k: zeros(p) for k, p in params.items()},
            'salt_index': {k: order.index(k) for k in big}}


def adam_count(count: torch.Tensor):
    """(count + 1, the step's dither salt): the step count after a step
    from ``count`` and the salt its bf16 moment streams start from."""
    count = count + 1
    return count, (count * 0x9E3779B9) & _U32


def adam_bias(count: torch.Tensor, dtype):
    """The bias corrections (1 - b1^count, 1 - b2^count) in ``dtype``."""
    c = count.to(dtype)
    c1 = 1.0 - torch.pow(torch.full_like(c, ADAM_B1), c)
    c2 = 1.0 - torch.pow(torch.full_like(c, ADAM_B2), c)
    return c1, c2


def moment_salt(salt0, leaf: int):
    """The first moment's salt of the bf16 leaf numbered ``leaf``; the
    second moment's is this plus 0x85EBCA77 (mod 2^32)."""
    return (salt0 + ((2 * leaf * 0x85EBCA77) & _U32)) & _U32


def adam_leaf(g, m_old, v_old, c1, c2, salt0, leaf: int):
    """One leaf's update and proposed moments, stored in the moments' own
    dtype (bf16 by stochastic rounding from the step's ``salt0``, as the
    bf16 leaf numbered ``leaf``)."""
    m = ADAM_B1 * m_old.to(g.dtype) + (1.0 - ADAM_B1) * g
    v = ADAM_B2 * v_old.to(g.dtype) + (1.0 - ADAM_B2) * g.square()
    u = (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
    if m_old.dtype == torch.bfloat16:
        s = moment_salt(salt0, leaf)
        return u, _sr_to_bf16(m, s), _sr_to_bf16(v, (s + 0x85EBCA77) & _U32)
    return u, m, v


def adam_updates(grads: dict, state: dict):
    """optax ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, no eps_root)
    with the moments upcast to the gradient's dtype for the update and
    stored back in their own dtype (bf16 by stochastic rounding, one
    dither stream per step, leaf and moment): (updates, proposed moments,
    proposed count).  Nothing is written: the trainer commits the
    proposals only when the step is finite.  The step's scalars are
    computed once per gradient dtype."""
    count, salt0 = adam_count(state['count'])
    bias = {}
    updates, mu, nu = {}, {}, {}
    for k, g in grads.items():
        if g.dtype not in bias:
            bias[g.dtype] = adam_bias(count, g.dtype)
        updates[k], mu[k], nu[k] = adam_leaf(
            g, state['mu'][k], state['nu'][k], *bias[g.dtype], salt0,
            state['salt_index'].get(k, 0))
    return updates, mu, nu, count


# ----------------------------------------------------------- natural gradient


def _phi(X: torch.Tensor) -> torch.Tensor:
    """tril with halved diagonal: the projection in the Cholesky
    differential."""
    return torch.tril(X) - 0.5 * X * torch.eye(X.shape[-1], dtype=X.dtype,
                                               device=X.device)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    M = W.shape[-1]
    return torch.eye(M, dtype=W.dtype, device=W.device).expand(W.shape)


def _expectation_vjp(mu, W, dmu, dW):
    """VJP of eta -> (mu, chol(S)) at W = chol(S), without refactorizing:
    S_bar = sym(W^-T phi(W^T W_bar) W^-1) by two triangular solves,
    eta2_bar = S_bar, eta1_bar = dmu - 2 S_bar mu."""
    P = _phi(W.transpose(-1, -2) @ dW)
    X = torch.linalg.solve_triangular(W.transpose(-1, -2), P, upper=True)
    S_bar = torch.linalg.solve_triangular(W, X, upper=False, left=False)
    S_bar = 0.5 * (S_bar + S_bar.transpose(-1, -2))
    eta1_bar = dmu - 2.0 * torch.einsum('rmn,rn->rm', S_bar, mu)
    return eta1_bar, S_bar


def _meanvarsqrt_to_natural(mu, W):
    """theta1 = S^-1 mu, theta2 = -1/2 S^-1."""
    Winv = torch.linalg.solve_triangular(W, _eye_like(W), upper=False)
    Sinv = Winv.transpose(-1, -2) @ Winv
    return torch.einsum('rmn,rn->rm', Sinv, mu), -0.5 * Sinv


def _natural_to_meanvarsqrt(theta1, theta2):
    """(theta1, theta2) -> (mu = S theta1, W = chol(S)), S = (-2 theta2)^-1,
    from one factorization by the exchange identity: with J the index
    reversal and Lf = chol(J P J), W = J Lf^-T J.  The factorized matrix is
    symmetrized first, as ``jnp.linalg.cholesky`` does."""
    P = (-2.0 * theta2).flip(-1, -2)
    Lf = linalg.cholesky(0.5 * (P + P.transpose(-1, -2)))
    Lfinv = torch.linalg.solve_triangular(Lf, _eye_like(Lf), upper=False)
    W = Lfinv.transpose(-1, -2).flip(-1, -2)
    S = W @ W.transpose(-1, -2)
    return torch.einsum('rmn,rn->rm', S, theta1), W


def natgrad_route(dtype, M: int) -> str:
    """The route of :func:`natgrad_update`'s solve W R^-T: for float32, the
    kernel route ``cuda_linalg.upper_route`` gives M -- 'upper' (K2 and K3
    on G's lower triangle and one product, M % 32 == 0 up to 2048) or
    'panels' (the panel driver around K2 and K3, multiples of 64 above
    2048) -- and 'library' for every other dtype or shape: the library
    factor of the index-reversed G and one triangular solve."""
    route = cuda_linalg.upper_route(M)
    return route[0] if dtype == torch.float32 and route else 'library'


def natgrad_update(q_mu, q_sqrt, dq_mu, dq_sqrt, gamma):
    """One natural-gradient step for a stack of GPs: q_mu [M, R], q_sqrt
    [R, M, M] (lower triangle used), d* their loss gradients, gamma a
    scalar tensor.  Returns the proposed (q_mu, q_sqrt), non-finite when
    the implied covariance leaves the PD cone.

    The theta round trip collapses: with X = W^T dW, H = sym(phi(X)) and
    G = I + 2 gamma H, S_new = W G^-1 W^T, and W_new = W R^-T is its
    Cholesky factor, R the upper factor of G (R R^T = G);
    mu_new = mu - gamma W_new (W_new^T dmu).

    The kernel routes of :func:`natgrad_route` build only G's lower
    triangle, I + gamma tril(X), and solve W R^-T by
    ``cuda_linalg.chol_right_solve_upper``, which reads only that
    triangle.  The library route builds the symmetric G and takes the
    library factor of the index-reversed G and one triangular solve.  Each
    call counts its route in ``profiling.COUNTERS['natgrad route
    <route>']``."""
    mu, W = q_mu.T, torch.tril(q_sqrt)                  # [R, M], [R, M, M]
    dmu, dW = dq_mu.T, torch.tril(dq_sqrt)
    XtW = W.transpose(-1, -2) @ dW
    M = W.shape[-1]
    eye = torch.eye(M, dtype=W.dtype, device=W.device)
    route = natgrad_route(W.dtype, M)
    profiling.COUNTERS[f'natgrad route {route}'] += 1
    if route != 'library':
        W_new = cuda_linalg.chol_right_solve_upper(
            gamma * torch.tril(XtW) + eye, W)
    else:
        P = _phi(XtW)
        G = 2.0 * gamma * (0.5 * (P + P.transpose(-1, -2))) + eye
        Lgf = linalg.cholesky(G.flip(-1, -2))
        Lgfinv = torch.linalg.solve_triangular(Lgf, _eye_like(Lgf),
                                               upper=False)
        W_new = W @ Lgfinv.flip(-1, -2).transpose(-1, -2)   # W R^-T
    t = torch.einsum('rmn,rm->rn', W_new, dmu)               # W_new^T dmu
    mu_new = mu - gamma * torch.einsum('rmn,rn->rm', W_new, t)
    return mu_new.T, W_new


def natgrad_update_theta(q_mu, q_sqrt, dq_mu, dq_sqrt, gamma):
    """The explicit theta-space round trip (Salimbeni et al. XiNat): the
    reference :func:`natgrad_update` is held against, kept off the hot
    path."""
    mu, W = q_mu.T, torch.tril(q_sqrt)
    deta1, deta2 = _expectation_vjp(mu, W, dq_mu.T, torch.tril(dq_sqrt))
    theta1, theta2 = _meanvarsqrt_to_natural(mu, W)
    mu_new, W_new = _natural_to_meanvarsqrt(theta1 - gamma * deta1,
                                            theta2 - gamma * deta2)
    return mu_new.T, W_new


def commit_verified(p, prev, new, ok, loss_ok) -> None:
    """NatGrad's guarded commit of one leaf, in place: ``new`` where
    ``ok`` holds, else the verified value.  A non-finite loss means ``p``
    (the last commit) is poisoned, so the verified value is then
    ``prev``'s; ``prev`` takes the verified value."""
    verified = torch.where(loss_ok, p, prev)
    prev.copy_(verified)
    p.copy_(torch.where(ok, new, verified))


def natgrad_step_with_backoff(params: list, grads: list, gamma, steps_back):
    """Natural gradient on every layer's (q_mu, q_sqrt): ``params`` and
    ``grads`` are [(q_mu, q_sqrt)] per layer.  Layers of the same (M, R)
    are stacked along the GP axis into one :func:`natgrad_update` call.
    On any non-finite proposal all layers keep their values and
    ``steps_back`` grows by one.  Returns (new [(q_mu, q_sqrt)],
    new steps_back, finite)."""
    groups: dict = {}
    for i, (q_mu, q_sqrt) in enumerate(params):
        groups.setdefault((tuple(q_mu.shape), tuple(q_sqrt.shape)),
                          []).append(i)
    proposals = [None] * len(params)
    for idxs in groups.values():
        mu_new, W_new = natgrad_update(
            torch.cat([params[i][0] for i in idxs], dim=1),
            torch.cat([params[i][1] for i in idxs], dim=0),
            torch.cat([grads[i][0] for i in idxs], dim=1),
            torch.cat([grads[i][1] for i in idxs], dim=0), gamma)
        off = 0
        for i in idxs:
            r = params[i][0].shape[1]
            proposals[i] = (mu_new[:, off:off + r], W_new[off:off + r])
            off += r
    finite = torch.ones((), dtype=torch.bool, device=gamma.device)
    for mu_new, W_new in proposals:
        finite = finite & torch.isfinite(mu_new).all() \
            & torch.isfinite(W_new).all()
    new = [(torch.where(finite, mu_new, q_mu),
            torch.where(finite, W_new, torch.tril(q_sqrt)))
           for (q_mu, q_sqrt), (mu_new, W_new) in zip(params, proposals)]
    return new, torch.where(finite, steps_back, steps_back + 1.0), finite
