"""Reference-format parameter snapshots (counterpart of
``deepcgp_tpu/utils/checkpoint.py``; the full-state snapshots are not
ported yet).

A snapshot is ``np.save`` of a flat {pathname: constrained value} dict plus
``global_step``, with the reference's ``DGP/layers/<i>/<param>`` pathnames,
so a snapshot written by the JAX package loads here and back.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deepcgp_tpu_torch.models.layers import ConvLayer


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def model_parameters(model, global_step: int) -> dict:
    """Flat {pathname: constrained value} dict (+ global_step).  Z0 is not
    saved: a restart re-anchors the KL prior at the loaded Z, as the
    reference does."""
    params = {}
    for i, layer in enumerate(model.layers):
        prefix = f'DGP/layers/{i}/'
        params[prefix + 'q_mu'] = _np(layer.q_mu)
        params[prefix + 'q_sqrt'] = np.tril(_np(layer.q_sqrt))
        params[prefix + 'feature/Z'] = _np(layer.Z)
        kern_prefix = prefix + 'kern/base_kernel/'
        if isinstance(layer, ConvLayer):
            base = layer.base_kernel
        elif hasattr(layer.kernel, 'base_kernel'):
            base = layer.kernel.base_kernel
            params[prefix + 'kern/patch_weights'] = _np(layer.kernel.patch_weights)
        else:
            # A plain last-layer kernel: gpflow's pathnames of a bare RBF
            # have no 'base_kernel/' segment.
            base = layer.kernel
            kern_prefix = prefix + 'kern/'
        params[kern_prefix + 'variance'] = _np(base.variance)
        params[kern_prefix + 'lengthscales'] = _np(base.lengthscales)
    params['global_step'] = int(global_step)
    return params


def save_model(path: str, model, global_step: int) -> None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    np.save(path, np.asarray(model_parameters(model, global_step), dtype=object))


def load_raw(path: str) -> dict:
    """The snapshot's dict.  It is a pickled object array: load only
    snapshots this program or the JAX package wrote."""
    return np.load(path, allow_pickle=True).item()


def parse_layer_parameters(parameters: dict, model_layers: int):
    """Pathnames -> per-layer dicts, with the shallower-to-deeper remap
    (the stored last layer moves into the new last slot).  Returns
    (global_step, {layer_index: params})."""
    parameters = dict(parameters)
    global_step = int(parameters.pop('global_step', 0))
    layer_params = {}
    for key, value in parameters.items():
        if 'layers' not in key:
            continue
        parts = key.split('/')
        path = '/'.join(parts[3:])
        values = layer_params.setdefault(int(parts[2]), {})
        # Priority matching of the reference loader.
        for name in ('q_mu', 'q_sqrt', 'Z', 'base_kernel/weight_variances',
                     'base_kernel/bias_variance', 'base_kernel/variance',
                     'base_kernel/lengthscales', 'patch_weights',
                     'lengthscales', 'weight_variances', 'bias_variance',
                     'variance'):
            if name in path:
                values[name] = value
                break
    stored_layers = max(layer_params.keys()) + 1
    if stored_layers > model_layers:
        raise ValueError("can't load a deeper checkpoint into a shallower model")
    if stored_layers != model_layers:
        layer_params[model_layers - 1] = layer_params.pop(stored_layers - 1)
    return global_step, layer_params


def load_layer_parameters(path: str, model_layers: int):
    return parse_layer_parameters(load_raw(path), model_layers)
