"""Analytic FLOP and byte accounting of one optimizer step (counterpart of
``deepcgp_tpu/utils/flops.py``, with the same formulas).

* :func:`training_step_flops` -- **model FLOPs**: the matmul-shaped work of
  the doubly-stochastic step (cross-covariances, triangular *solves*,
  Choleskys, the conditional's mean and q_sqrt products, the KL solves),
  backward counted as twice the forward.  MFU is quoted from this figure,
  so it stays comparable across implementations: arithmetic an
  implementation adds (explicit factor inverses, recomputed kernels) earns
  no MFU.
* :func:`training_step_hardware_flops` -- what the inverse-form
  implementation executes: the conditional's and the KL's solves run as
  dense products against the factor inverses that ``chol_with_inv``
  returns (K1 + K3 on the card), more arithmetic than a triangular solve.
* :func:`training_step_min_bytes` -- the model-minimal HBM bytes of a step.

Elementwise work (exp epilogues, reparameterisation, the likelihood's
quadrature) is bandwidth-bound and left out of both FLOP counts.  The
counts read the port's model: ``layer.view.patch_count``, ``layer.Z``,
``layer.gp_count``, ``layer.white``, ``model.num_samples``.
"""

from __future__ import annotations

import torch

from deepcgp_tpu_torch.training.optim import jax_leaf_order


def _conv_layer_flops(layer, N: int, hardware: bool):
    """(per-evaluation flops, once-per-step flops) of a hidden ConvLayer:
    P patch positions, M inducing patches of length L, R GPs a position,
    batch N."""
    P = layer.view.patch_count
    M, L = layer.Z.shape
    R = layer.gp_count
    solves = 1 if layer.white else 2
    grams = 1 if layer.white else 2    # Lm (+ the frozen-Z0 KL prior's Lp)
    # A triangular solve with k right-hand sides ~ k M^2 flops; the
    # inverse form runs it as a dense k x M x M product (twice that).
    solve_cost = 2 * P * N * M * M if hardware else P * N * M * M
    per_eval = (
        2 * P * N * M * L              # Kuf cross-covariance product
        + solves * solve_cost          # whitening solve(s), P N rhs
        + 2 * P * N * M * R            # fmean = A f
        + 2 * R * P * N * M * M        # q_sqrt variance term (A L per GP)
    )
    if hardware:
        per_step = (
            2 * M * M * L                      # Kuu
            + grams * (M ** 3 // 3 + M ** 3)   # chol + explicit L^-1 each
            + (0 if layer.white else (2 * R + 2) * M ** 3)
            # KL trace, inverse form: sum_r Lq Lq^T (2R M^3) + Lp^-T Lp^-1
        )
    else:
        per_step = (
            2 * M * M * L              # Kuu
            + M ** 3 // 3              # chol(Kuu)
            + (R + 1) * M ** 3         # KL: R M-rhs triangular solves + chol
        )
    return per_eval, per_step


def _svgp_layer_flops(layer, N: int, hardware: bool):
    """The same for the last SVGPLayer: a patch-sum kernel over P
    positions, or a plain RBF (P = 1)."""
    M, L = layer.Z.shape
    R = layer.num_outputs
    view = getattr(layer.kernel, 'view', None)
    P = view.patch_count if view is not None else 1
    solves = 1 if layer.white else 2
    solve_cost = 2 * N * M * M if hardware else N * M * M
    per_eval = (
        2 * P * N * M * L          # Kzx (patch-summed when P > 1)
        + solves * solve_cost
        + 2 * N * M * R
        + 2 * R * N * M * M
    )
    if hardware:
        per_step = (
            2 * M * M * L
            + M ** 3 // 3 + M ** 3     # chol + explicit L^-1 (the gram is
                                       # shared by conditional and KL prior)
            + (0 if layer.white else (2 * R + 2) * M ** 3)
        )
    else:
        per_step = (
            2 * M * M * L
            + M ** 3 // 3
            + (R + 1) * M ** 3
        )
    return per_eval, per_step


def _step_flops(model, batch_size: int, hardware: bool) -> float:
    """The first layer's conditional is evaluated once and sampled S times
    (its input does not depend on the sample); every later layer runs S
    evaluations.  Forward plus backward = 3 x forward."""
    S = model.num_samples
    total = 0.0
    for i, layer in enumerate(model.layers):
        if hasattr(layer, 'gp_count'):
            per_eval, per_step = _conv_layer_flops(layer, batch_size,
                                                   hardware)
        else:
            per_eval, per_step = _svgp_layer_flops(layer, batch_size,
                                                   hardware)
        evals = 1 if i == 0 else S
        total += evals * per_eval + per_step
    return 3.0 * total


def training_step_flops(model, batch_size: int) -> float:
    """Analytic *model* FLOPs of ONE optimizer step (forward + backward);
    MFU is quoted from this figure."""
    return _step_flops(model, batch_size, hardware=False)


def training_step_hardware_flops(model, batch_size: int) -> float:
    """Analytic FLOPs the inverse-form implementation executes a step."""
    return _step_flops(model, batch_size, hardware=True)


def _leaf_bytes(model) -> int:
    """Bytes of every leaf the JAX package's model pytree holds: the
    parameters and the buffers it keeps as leaves (the KL anchors Z0, an
    identity mean's filter)."""
    return sum(t.numel() * t.element_size() for _, t in jax_leaf_order(model))


def training_step_min_bytes(model, batch_size: int,
                            moment_bytes_per_param: int = 8) -> float:
    """Analytic MODEL-MINIMAL HBM bytes of ONE optimizer step, assuming no
    intermediate ever leaves the chip: the minibatch rows read once, every
    parameter read twice (forward and backward), every gradient written
    and read once, the optimizer moments read and written
    (``moment_bytes_per_param`` = 8 for two float32 Adam moments) and
    every updated parameter written once.  Kernel matrices, extracted
    patches and Monte-Carlo samples are implementation traffic, not part
    of the floor."""
    p_bytes = _leaf_bytes(model)
    n_params = p_bytes / 4                       # float32 leaves
    # Minibatch row width: the first layer's input dimensionality.
    view = getattr(model.layers[0], 'view', None)
    if view is None:
        view = getattr(getattr(model.layers[0], 'kernel', None), 'view', None)
    if view is not None:
        H, W = view.input_size
        D = H * W * view.feature_maps
    else:
        D = int(model.layers[0].Z.shape[1])
    batch_read = batch_size * D * 4
    return float(batch_read
                 + 2 * p_bytes          # params read forward + backward
                 + 2 * p_bytes          # grads written + read
                 + 2 * n_params * moment_bytes_per_param  # moments r + w
                 + p_bytes)             # updated params written


# Dense BF16 tensor-core peak per card, FLOP/s, keyed by a substring of
# torch.cuda.get_device_name(), from NVIDIA's H100 data sheet (dense rates,
# half the sparse figure): the H100 SXM5 at its 700 W power limit, and the
# H100 PCIe at 350 W.  The port computes in float32 (TF32 off), well below
# this peak; MFU is quoted against the BF16 peak by convention, so the
# share is conservative.  A card set below its limit runs slower: state
# nvidia-smi's power.limit beside every share.
GPU_PEAK_FLOPS = {
    'H100 80GB HBM3': 989.4e12,   # H100 SXM5, 700 W
    'H100 PCIe': 756.5e12,        # H100 PCIe, 350 W
}


def peak_flops(device_name: str) -> float:
    """The table's peak for a card name, NaN for a card it lacks."""
    for key, peak in GPU_PEAK_FLOPS.items():
        if key in device_name:
            return peak
    return float('nan')


def device_peak_flops(device) -> float:
    """Dense BF16 peak FLOP/s of ``device`` (a torch.device or its spec);
    NaN for the CPU and for a card the table lacks."""
    device = torch.device(device)
    if device.type != 'cuda':
        return float('nan')
    return peak_flops(torch.cuda.get_device_name(device))
