"""The benchmark's yardstick: the card's peaks, the model FLOPs of a
training step and of a served request, and the least time of the
cross-covariance, all from a configuration file's shapes.

The FLOP count is a frozen copy of ``deepcgp_tpu_torch/utils/flops.py``
(``training_step_flops``, model FLOPs) at commit 1992fdc, rewritten to read
the configuration file instead of a built model, so that a change to the
program cannot move the benchmark's numbers.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at its 700 W limit.  The port
# computes in float32 with TF32 off; its fused cross-covariance kernels
# take float32 accuracy from split TF32, three TF32 passes a product.  So
# the compute peak of every roofline and MFU here is dense TF32 over three:
# the fastest float32-accurate rate the card offers.
TF32_PEAK_FLOPS = 495e12
COMPUTE_PEAK_FLOPS = TF32_PEAK_FLOPS / 3
HBM_BYTES_PER_S = 3.35e12
FLOAT_BYTES = 4


def out_size(size: int, f: int, s: int) -> int:
    return (size - f) // s + 1


def layers(config: dict) -> list:
    """Per layer: dict(P, M, L, R, white, hidden, image=(H, W, C) of its
    input)."""
    H, W, C = config['image_shape']
    out = []
    depth = len(config['M'])
    for i, M in enumerate(config['M']):
        f, s = config['filter_sizes'][i], config['strides'][i]
        hidden = i < depth - 1
        P = out_size(H, f, s) * out_size(W, f, s)
        R = config['feature_maps'][i] if hidden else config['num_classes']
        out.append(dict(P=P, M=M, L=f * f * C, R=R, white=config['white'],
                        hidden=hidden, image=(H, W, C)))
        if hidden:
            H, W, C = out_size(H, f, s), out_size(W, f, s), R
    return out


def _per_eval(layer: dict, N: int) -> float:
    """One evaluation of a layer's conditional at N input rows (the copy's
    ``per_eval``; the last layer's Kzx is patch-summed)."""
    P, M, L, R = layer['P'], layer['M'], layer['L'], layer['R']
    solves = 1 if layer['white'] else 2
    if layer['hidden']:
        return (2 * P * N * M * L + solves * P * N * M * M
                + 2 * P * N * M * R + 2 * R * P * N * M * M)
    return (2 * P * N * M * L + solves * N * M * M + 2 * N * M * R
            + 2 * R * N * M * M)


def _per_step(layer: dict, kl: bool = True) -> float:
    """Once per step: Kuu, its factor and (``kl``) the KL's solves."""
    M, L, R = layer['M'], layer['L'], layer['R']
    return 2 * M * M * L + M ** 3 // 3 + ((R + 1) * M ** 3 if kl else 0)


def training_step_flops(config: dict, batch: int, samples: int) -> float:
    """Model FLOPs of one optimizer step, forward and backward (3 x the
    forward): the first layer evaluated once, every later one S times."""
    total = 0.0
    for i, layer in enumerate(layers(config)):
        evals = 1 if i == 0 else samples
        total += evals * _per_eval(layer, batch) + _per_step(layer)
    return 3.0 * total


def request_flops(config: dict, rows: int, samples: int) -> float:
    """Model FLOPs of one served request (the forward of ``predict_y``):
    each layer's conditional at the request's rows, S times after the
    first layer, and its Kuu and factor; no KL, no backward."""
    total = 0.0
    for i, layer in enumerate(layers(config)):
        evals = 1 if i == 0 else samples
        total += evals * _per_eval(layer, rows) + _per_step(layer, kl=False)
    return total


def _bound_s(ops: float, nbytes: float):
    t_ops, t_bytes = ops / COMPUTE_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes else 'bytes')


def cross_covariance_parts(config: dict, batch: int, samples: int) -> list:
    """The work of one training step's cross-covariances, forward and
    backward, as [(what, operations, bytes)]: each layer's kernel between
    its patches and its inducing patches (a hidden layer's [P, N, M] is an
    output the conditional reads; the last layer's patch-summed Kzx [N, M]
    and its Kdiag, w^T k(x_p, x_q) w / P^2, are, and the [N, P, M] terms
    are not), and each Kuu gram (a hidden layer's KL prior adds the gram
    of its initial Z).  Operations: 2 per multiply-add of the distance
    products (the symmetric grams' half); the backward twice the forward,
    once where the input takes no gradient (the data).  Bytes: each input
    read and each output written once forward; the inputs and the
    outputs' cotangents read and the inputs' gradients written backward."""
    parts = []
    for i, layer in enumerate(layers(config)):
        P, M, L = layer['P'], layer['M'], layer['L']
        H, W, C = layer['image']
        N = batch if i == 0 else batch * samples
        image = FLOAT_BYTES * N * H * W * C
        z = FLOAT_BYTES * M * L
        if layer['hidden']:
            ops = 2 * N * P * M * L
            out = FLOAT_BYTES * N * P * M
        else:
            ops = 2 * N * P * M * L + N * P * (P + 1) * L
            out = FLOAT_BYTES * (N * M + N)
        grads = 1 if i == 0 else 2            # dZ; and d(input) after layer 0
        back_bytes = image + z + out + z + (image if i else 0)
        parts.append((f'layer {i} cross-covariance', (1 + grads) * ops,
                      image + z + out + back_bytes))
        grams = 1 if (layer['white'] or not layer['hidden']) else 2
        g_ops = M * (M + 1) * L
        g_bytes = FLOAT_BYTES * M * M
        parts.append((f'layer {i} Kuu grams', grams * (g_ops + 2 * M * M * L),
                      grams * (2 * z + 2 * g_bytes + z)))
    return parts


def cross_covariance_least_s(config: dict, batch: int, samples: int):
    """(least seconds of a step's cross-covariance work, what bounds most
    of it): each part at the larger of its operations over the compute
    peak and its bytes over HBM's rate, summed."""
    total, by = 0.0, {'operations': 0.0, 'bytes': 0.0}
    for _, ops, nbytes in cross_covariance_parts(config, batch, samples):
        t, bound = _bound_s(ops, nbytes)
        total += t
        by[bound] += t
    return total, max(by, key=by.get)
