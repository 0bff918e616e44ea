"""Model assembly from flags and loaded parameters (counterpart of
``deepcgp_tpu/models/builder.py``).

Serving starts from a snapshot, so this builds only from loaded
parameters: every layer needs its saved Z.  Fresh initialisation (k-means
inducing patches, identity-conv propagation of the init data) comes with
the training slice; only the image shape is needed here.
"""

from __future__ import annotations

import numpy as np
import torch

from deepcgp_tpu_torch import config
from deepcgp_tpu_torch.models.base_kernels import RBF
from deepcgp_tpu_torch.models.conv_kernels import AdditivePatchKernel, ConvKernel
from deepcgp_tpu_torch.models.dgp import DGP
from deepcgp_tpu_torch.models.layers import ConvLayer, SVGPLayer
from deepcgp_tpu_torch.models.likelihoods import MultiClass
from deepcgp_tpu_torch.models.mean_functions import Zero
from deepcgp_tpu_torch.models.views import FullView
from deepcgp_tpu_torch.ops.patches import out_size
from deepcgp_tpu_torch.utils.transforms import lower_triangular_unflatten


def parse_ints(int_string) -> list:
    """'384,384' -> [384, 384]."""
    if str(int_string) == '':
        return []
    return [int(i) for i in str(int_string).split(',')]


def _tensor(value, dtype, device):
    return torch.tensor(np.asarray(value), dtype=dtype, device=device)


def _q_sqrt(value, M, dtype, device):
    q = _tensor(value, dtype, device)
    return lower_triangular_unflatten(q, M) if q.ndim == 2 else q


def _saved_Z(params: dict, i: int):
    if 'Z' not in params:
        raise NotImplementedError(
            f'layer {i} has no saved Z: fresh inducing-point initialisation '
            'comes with the training slice (ROADMAP queue A)')
    return params['Z']


def build_model(flags, image_shape, loaded_parameters: dict, *, dtype=None,
                device=None) -> DGP:
    """Hidden ConvLayers plus a final SVGP layer over images of
    ``image_shape`` = (H, W, C), from the per-layer dict of
    ``checkpoint.parse_layer_parameters``.  ``flags`` carries the training
    CLI's M, feature_maps, filter_sizes, strides, base_kernel,
    last_kernel, white and identity_mean."""
    device = config.default_device(device)
    dtype = dtype or config.FLOAT_TYPE
    if flags.base_kernel != 'rbf':
        raise NotImplementedError(f'base kernel {flags.base_kernel!r} is not '
                                  'ported yet (ROADMAP queue A)')
    if flags.last_kernel not in ('conv', 'add'):
        raise NotImplementedError(f'last kernel {flags.last_kernel!r} is not '
                                  'ported yet (ROADMAP queue A)')
    if flags.identity_mean:
        raise NotImplementedError('the identity conv mean is not ported yet '
                                  '(ROADMAP queue A)')
    Ms = parse_ints(flags.M)
    feature_maps = parse_ints(flags.feature_maps)
    strides = parse_ints(flags.strides)
    filter_sizes = parse_ints(flags.filter_sizes)
    if len(strides) != len(filter_sizes) or len(feature_maps) != len(Ms) - 1:
        raise ValueError('flags: inconsistent per-layer lists')
    kw = dict(dtype=dtype, device=device)

    H, W, C = image_shape
    layers = []
    for i, fm in enumerate(feature_maps):
        params = loaded_parameters.get(i, {})
        view = FullView(input_size=(H, W), filter_size=filter_sizes[i],
                        feature_maps=C, stride=strides[i])
        Z = _tensor(_saved_Z(params, i), **kw)
        base = RBF.create(params.get('base_kernel/variance', 5.0),
                          params.get('base_kernel/lengthscales', 5.0), **kw)
        layers.append(ConvLayer(
            base, Z, _tensor(params['q_mu'], **kw),
            _q_sqrt(params['q_sqrt'], Z.shape[0], **kw), Z, Zero(), view,
            white=flags.white, gp_count=fm))
        H = out_size(H, filter_sizes[i], strides[i])
        W = out_size(W, filter_sizes[i], strides[i])
        C = fm

    last = len(Ms) - 1
    params = loaded_parameters.get(last, {})
    Z = _saved_Z(params, last)
    if np.asarray(Z).shape[1] != filter_sizes[-1] ** 2 * C:
        raise NotImplementedError(
            'the saved last-layer Z does not match the filter size: fresh '
            'initialisation comes with the training slice (ROADMAP queue A)')
    Z = _tensor(Z, **kw)
    view = FullView(input_size=(H, W), filter_size=filter_sizes[-1],
                    feature_maps=C, stride=strides[-1])
    base = RBF.create(params.get('base_kernel/variance', 5.0),
                      params.get('base_kernel/lengthscales', 5.0), **kw)
    cls = ConvKernel if flags.last_kernel == 'conv' else AdditivePatchKernel
    kernel = cls.create(base, view, params.get('patch_weights'), **kw)
    layers.append(SVGPLayer(
        kernel, Z, _tensor(params['q_mu'], **kw),
        _q_sqrt(params['q_sqrt'], Z.shape[0], **kw), Zero(10),
        white=flags.white, num_outputs=10))
    return DGP(layers, MultiClass(10))
