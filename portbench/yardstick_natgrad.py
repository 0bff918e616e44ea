"""The yardstick of a natural-gradient step of the single-layer SVGP: the
least time of the update of every GP's (q_mu, q_sqrt), and the model FLOPs
of one step, from a configuration file's shapes.

The update, per the shapes [R, M, M] of the R covariance factors W (the
natural-gradient step of ``training/optim.py``'s ``natgrad_update``, as
the algorithm needs it, not as any kernel does it; W and dW are lower
triangular, and a product or solve of triangles counts only the
triangles' terms):

* tril(X), X = W^T dW (only G's lower triangle is used), RM^3 / 3
  operations;
* the factor of G = I + gamma tril(X) (K2), RM^3 / 3;
* the solve W R^-T (K3 and a product): a lower-triangular right-hand
  side and a lower-triangular result, RM^3 / 3;
* the mean's update mu - gamma W_new (W_new^T dmu), two triangular
  mat-vecs, 2RM^2;

each [R, M, M] operand read and each written once, at 4 bytes.  Each part
is bounded by the larger of its operations over the compute peak and its
bytes over HBM's rate, and the parts are summed, as
``yardstick.cross_covariance_least_s`` bounds the cross-covariance.  At
[R, M] = [10, 1024] bytes bound every part.

A step's model FLOPs: the SVGP's forward -- the cross-covariance over the
D flattened pixels, the conditional's two solves, its mean and its
q_sqrt term (a lower triangle times the [M, N] solve, per GP) at the
batch's rows, once (a one-layer model's S samples tile the same
marginals, as ``yardstick.training_step_flops`` evaluates the first layer
once) -- and once a step Kuu, its factor and the KL's R
triangle-by-triangle solves L_K^-1 L_q and its mean's solve; the backward
twice the forward; and the update above.
"""

from __future__ import annotations

from portbench.yardstick import (COMPUTE_PEAK_FLOPS, FLOAT_BYTES,
                                 HBM_BYTES_PER_S)


def shapes(config: dict) -> dict:
    """M, R and D of the configuration's one SVGP layer."""
    H, W, C = config['image_shape']
    return {'M': config['M'][-1], 'R': config['num_classes'],
            'D': H * W * C}


def natgrad_parts(R: int, M: int) -> list:
    """[(what, operations, bytes)] of one natural-gradient update."""
    mat, vec = FLOAT_BYTES * R * M * M, FLOAT_BYTES * R * M
    tri = R * M ** 3 / 3
    return [('tril(W^T dW)', tri, 3 * mat),
            ('the factor of G', tri, 2 * mat),
            ('the solve W R^-T', tri, 3 * mat),
            ('the mean update', 2 * R * M ** 2, mat + 3 * vec)]


def natgrad_least_s(R: int, M: int):
    """(least seconds of one update, what bounds most of it)."""
    total, by = 0.0, {'operations': 0.0, 'bytes': 0.0}
    for _, ops, nbytes in natgrad_parts(R, M):
        t_ops, t_bytes = ops / COMPUTE_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
        total += max(t_ops, t_bytes)
        by['operations' if t_ops >= t_bytes else 'bytes'] += max(t_ops,
                                                                 t_bytes)
    return total, max(by, key=by.get)


def natgrad_flops(R: int, M: int) -> float:
    return sum(ops for _, ops, _ in natgrad_parts(R, M))


def forward_flops(M: int, R: int, D: int, N: int) -> float:
    """The ELBO's forward at N rows: the conditional
    (2NMD + 2NM^2 + 2NMR + RNM^2), Kuu (2M^2 D), its factor (M^3 / 3) and
    the KL's solves (RM^3 / 3 + RM^2)."""
    return (2 * N * M * D + 2 * N * M * M + 2 * N * M * R
            + R * N * M * M + 2 * M * M * D + M ** 3 / 3
            + R * M ** 3 / 3 + R * M * M)


def training_step_flops(config: dict, batch: int) -> float:
    """Model FLOPs of one NatGrad step: 3 x the forward, plus the
    update."""
    s = shapes(config)
    return (3.0 * forward_flops(s['M'], s['R'], s['D'], batch)
            + natgrad_flops(s['R'], s['M']))
