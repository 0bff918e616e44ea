"""Carry a JAX-package model's parameters over to the port.

The port never imports the JAX package.  Two ways in:

* :func:`from_jax_parameters` takes what the JAX package's
  ``deepcgp_tpu.utils.checkpoint.model_parameters(model, step)`` returns
  -- a flat {pathname: np.ndarray} dict of constrained values, the same
  content as a reference-format snapshot -- and builds the port's model
  from it with the builder, for the models the CLI's flags describe.
* :func:`load_jax_leaves` fills a port model that the caller has built
  with the same structure -- a model the builder does not make, such as a
  stack with a ``RandomPartialView`` hidden layer or the regression DGP
  with its Gaussian likelihood -- from every leaf of the JAX model, raw
  values as the JAX package holds them (the kernels' and the
  likelihood's raw parameters, Z, q_mu, q_sqrt, the KL anchors Z0, the
  mean functions' filters).  On the JAX side the leaves are

      {''.join(str(k) for k in path): np.asarray(leaf)
       for path, leaf in jax.tree_util.tree_flatten_with_path(model)[0]}

  keyed as '.layers[0].Z'; the port model's ``num_data`` and
  ``num_samples`` are set where it is built.
"""

from __future__ import annotations

import numpy as np
import torch

from deepcgp_tpu_torch.models.builder import build_model, parse_ints
from deepcgp_tpu_torch.models.layers import ConvLayer
from deepcgp_tpu_torch.training.optim import jax_keystr, jax_leaf_order
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


@torch.no_grad()
def load_jax_leaves(model, leaves: dict):
    """Copy every leaf of the JAX model (``leaves``, keyed by JAX key path,
    see the module docstring) into the port ``model`` of the same
    structure, in place, keeping each tensor's dtype and device.  The two
    must hold the same leaves, shape for shape; returns ``model``."""
    ours = {jax_keystr(name): t for name, t in jax_leaf_order(model)}
    if set(ours) != set(leaves):
        raise ValueError('load_jax_leaves: the models differ: port only '
                         f'{sorted(set(ours) - set(leaves))}, JAX only '
                         f'{sorted(set(leaves) - set(ours))}')
    for key, t in ours.items():
        value = torch.as_tensor(np.array(leaves[key]))
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f'load_jax_leaves: {key} is {tuple(value.shape)} '
                             f'in JAX, {tuple(t.shape)} here')
        t.copy_(value)
    return model
