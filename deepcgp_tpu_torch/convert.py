"""Carry a JAX-package model's parameters over to the port.

The port never imports the JAX package; this takes what its
``deepcgp_tpu.utils.checkpoint.model_parameters(model, step)`` returns --
a flat {pathname: np.ndarray} dict of constrained values, the same content
as a reference-format snapshot -- and builds the port's model from it.
"""

from __future__ import annotations

import numpy as np
import torch

from deepcgp_tpu_torch.models.builder import build_model, parse_ints
from deepcgp_tpu_torch.models.layers import ConvLayer
from deepcgp_tpu_torch.utils.checkpoint import parse_layer_parameters


def from_jax_parameters(flags, image_shape, params: dict, Z0=None, *,
                        num_data: int = 0, dtype=None, device=None):
    """The port's DGP from the JAX model's flags, input ``image_shape``
    (H, W, C) and flat parameter dict.  The dict does not hold the frozen
    KL-prior anchors Z0 of the hidden layers; ``Z0`` (one [M, L] array per
    ConvLayer, in order) supplies them, else each anchor is a detached
    copy of its layer's Z.  ``num_data`` is the JAX model's ``num_data``
    (the ELBO's scale); ``dtype`` defaults to the dtype of the
    parameters."""
    if dtype is None:
        q_mu = next(v for k, v in params.items() if k.endswith('q_mu'))
        dtype = (torch.float64 if np.asarray(q_mu).dtype == np.float64
                 else torch.float32)
    _, layer_params = parse_layer_parameters(params, len(parse_ints(flags.M)))
    model = build_model(flags, image_shape, layer_params, num_data=num_data,
                        dtype=dtype, device=device)
    conv_layers = [layer for layer in model.layers if isinstance(layer, ConvLayer)]
    for layer, z0 in zip(conv_layers, Z0 or ()):
        layer.Z0 = torch.as_tensor(np.array(z0), dtype=layer.Z.dtype,
                                   device=layer.Z.device)
    return model
