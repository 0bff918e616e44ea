"""Model assembly from flags, loaded parameters and training images
(counterpart of ``deepcgp_tpu/models/builder.py``).

A layer whose parameters were loaded keeps them; every other parameter is
initialised as the reference does: inducing patches by k-means of sampled
training patches, propagated to the next layer by the identity
convolution (a plain-RBF last layer's inducing points by k-means++ of its
flattened inputs); q_mu zero; q_sqrt = 1e-5 chol(Kuu) for a fresh hidden layer
and chol(Kuu) for a fresh last layer (the identity, scaled alike, when
whitened).  Fresh initialisation needs the training images; serving
builds from a snapshot alone.
"""

from __future__ import annotations

import numpy as np
import torch

from deepcgp_tpu_torch import config
from deepcgp_tpu_torch.models.base_kernels import RBF, ArcCosine
from deepcgp_tpu_torch.models.conv_kernels import (AdditivePatchKernel,
                                                   ConvKernel,
                                                   MultiOutputConvKernel)
from deepcgp_tpu_torch.models.dgp import DGP
from deepcgp_tpu_torch.models.inducing import (inducing_points_from_data,
                                               patch_inducing_points)
from deepcgp_tpu_torch.models.layers import (ConvLayer, SVGPLayer, fresh_q_sqrt,
                                             kernel_gram)
from deepcgp_tpu_torch.models.likelihoods import MultiClass
from deepcgp_tpu_torch.models.mean_functions import Conv2dMean, Zero
from deepcgp_tpu_torch.models.views import FullView
from deepcgp_tpu_torch.ops.linalg import add_jitter
from deepcgp_tpu_torch.ops.patches import out_size
from deepcgp_tpu_torch.utils.transforms import lower_triangular_unflatten

# Training images the identity convolution propagates to the next layer's
# initialisation (the reference's 1000).
IDENTITY_CONV_IMAGES = 1000
# Fresh hidden layers start with low variance (reference models.py:136-138).
FRESH_HIDDEN_Q_SQRT_SCALE = 1e-5


def parse_ints(int_string) -> list:
    """'384,384' -> [384, 384]."""
    if str(int_string) == '':
        return []
    return [int(i) for i in str(int_string).split(',')]


def identity_conv(NHWC_X: np.ndarray, filter_size: int, fm_out: int,
                  stride: int, idx) -> np.ndarray:
    """The identity-mean convolution of the images ``NHWC_X[idx]``: its
    delta filter makes the VALID conv a strided centre-pixel slice summed
    over input channels, repeated over ``fm_out`` output maps."""
    X = np.asarray(NHWC_X)[np.asarray(idx)]
    c = filter_size // 2
    Ho = (X.shape[1] - filter_size) // stride + 1
    Wo = (X.shape[2] - filter_size) // stride + 1
    centers = X[:, c:c + stride * Ho:stride, c:c + stride * Wo:stride, :]
    out = centers.sum(axis=-1, keepdims=True)
    return np.repeat(out, fm_out, axis=-1).astype(X.dtype)


def _tensor(value, dtype, device):
    return torch.tensor(np.asarray(value), dtype=dtype, device=device)


def _q_sqrt(value, M, dtype, device):
    q = _tensor(value, dtype, device)
    return lower_triangular_unflatten(q, M) if q.ndim == 2 else q


def _fresh_Z(H_X, i, M, filter_size, generator, dtype, device):
    if H_X is None:
        raise ValueError(f'layer {i} has no saved Z: pass the training '
                         'images to initialise it')
    return patch_inducing_points(H_X, M, filter_size, generator=generator,
                                 dtype=dtype, device=device)


def _white_q_sqrt(M, count, scale, dtype, device):
    eye = torch.eye(M, dtype=dtype, device=device) * scale
    return eye.expand(count, M, M).clone()


def build_model(flags, image_shape, loaded_parameters: dict | None = None, *,
                images: np.ndarray | None = None,
                generator: torch.Generator | None = None,
                num_data: int | None = None, dtype=None, device=None) -> DGP:
    """Hidden ConvLayers (none for an empty ``feature_maps``; an RBF or,
    for base_kernel 'acos', an order-0 ArcCosine base; the identity conv
    mean under identity_mean) plus a final SVGP layer -- a patch-sum
    kernel ('conv', 'add') over an RBF base, or an ARD RBF over the
    flattened input ('rbf') -- over images of
    ``image_shape`` = (H, W, C), from the per-layer dict of
    ``checkpoint.parse_layer_parameters``.  ``flags`` carries the training
    CLI's M, feature_maps, filter_sizes, strides, base_kernel,
    last_kernel, white and identity_mean (and num_samples, default 10).
    ``images`` [N, H, W, C] (numpy) are the training images that fresh
    layers initialise from, with draws from ``generator``; ``num_data``
    defaults to their count."""
    device = config.default_device(device)
    dtype = dtype or config.FLOAT_TYPE
    loaded_parameters = loaded_parameters or {}
    if flags.base_kernel not in ('rbf', 'acos'):
        raise ValueError(f'base kernel {flags.base_kernel!r}: not rbf or acos')
    if flags.last_kernel not in ('conv', 'add', 'rbf'):
        raise ValueError(f'last kernel {flags.last_kernel!r}: not conv, add '
                         'or rbf')
    Ms = parse_ints(flags.M)
    feature_maps = parse_ints(flags.feature_maps)
    strides = parse_ints(flags.strides)
    filter_sizes = parse_ints(flags.filter_sizes)
    if len(strides) != len(filter_sizes) or len(feature_maps) != len(Ms) - 1:
        raise ValueError('flags: inconsistent per-layer lists')
    if images is not None:
        images = np.asarray(images).reshape(-1, *image_shape)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if num_data is None:
            num_data = images.shape[0]
    kw = dict(dtype=dtype, device=device)

    H, W, C = image_shape
    H_X = images
    layers = []
    for i, fm in enumerate(feature_maps):
        params = loaded_parameters.get(i, {})
        f, s = filter_sizes[i], strides[i]
        view = FullView(input_size=(H, W), filter_size=f, feature_maps=C,
                        stride=s)
        if 'Z' in params:
            Z = _tensor(params['Z'], **kw)
        else:
            Z = _fresh_Z(H_X, i, Ms[i], f, generator, **kw)
        base = _hidden_base_kernel(flags.base_kernel, params, **kw)
        M = Z.shape[0]
        q_mu = (_tensor(params['q_mu'], **kw) if 'q_mu' in params
                else torch.zeros(M, fm, **kw))
        if params.get('q_sqrt') is not None:
            q_sqrt = _q_sqrt(params['q_sqrt'], M, **kw)
        elif flags.white:
            q_sqrt = _white_q_sqrt(M, fm, FRESH_HIDDEN_Q_SQRT_SCALE, **kw)
        else:
            q_sqrt = fresh_q_sqrt(MultiOutputConvKernel(base, 1).Kuu(Z), fm,
                                  FRESH_HIDDEN_Q_SQRT_SCALE)
        mean = (Conv2dMean.create(f, C, fm, stride=s, **kw)
                if flags.identity_mean else Zero())
        layers.append(ConvLayer(base, Z, q_mu, q_sqrt, mean, view,
                                white=flags.white, gp_count=fm))
        if H_X is not None:
            idx = torch.randint(0, H_X.shape[0], (IDENTITY_CONV_IMAGES,),
                                generator=generator, device=generator.device)
            H_X = identity_conv(H_X, f, fm, s, idx.cpu().numpy())
        H, W, C = out_size(H, f, s), out_size(W, f, s), fm

    last = len(Ms) - 1
    params = dict(loaded_parameters.get(last, {}))
    if flags.last_kernel == 'rbf':
        kernel, Z = _rbf_last_layer(params, H_X, Ms[-1], H * W * C, generator,
                                    **kw)
    else:
        kernel, Z = _patch_last_layer(flags, params, H_X, last, Ms[-1], H, W,
                                      C, filter_sizes[-1], strides[-1],
                                      generator, **kw)
    M, R = Z.shape[0], 10
    q_mu = (_tensor(params['q_mu'], **kw) if 'q_mu' in params
            else torch.zeros(M, R, **kw))
    if params.get('q_sqrt') is not None:
        q_sqrt = _q_sqrt(params['q_sqrt'], M, **kw)
    elif flags.white:
        q_sqrt = _white_q_sqrt(M, R, 1.0, **kw)
    else:
        q_sqrt = fresh_q_sqrt(add_jitter(kernel_gram(kernel, Z), config.JITTER), R)
    layers.append(SVGPLayer(kernel, Z, q_mu, q_sqrt, Zero(R),
                            white=flags.white, num_outputs=R))
    return DGP(layers, MultiClass(10), num_data=num_data or 0,
               num_samples=int(getattr(flags, 'num_samples', 10)))


def _hidden_base_kernel(name, params, dtype, device):
    """A hidden layer's base kernel: RBF, or order-0 ArcCosine for 'acos',
    with its loaded hyperparameters or the reference's defaults."""
    kw = dict(dtype=dtype, device=device)
    if name == 'acos':
        return ArcCosine.create(
            params.get('base_kernel/variance', 1.0),
            params.get('base_kernel/weight_variances', 1.0),
            params.get('base_kernel/bias_variance', 1.0), order=0, **kw)
    return RBF.create(params.get('base_kernel/variance', 5.0),
                      params.get('base_kernel/lengthscales', 5.0), **kw)


def _patch_last_layer(flags, params, H_X, i, M, H, W, C, f, stride,
                      generator, dtype, device):
    """(ConvKernel or AdditivePatchKernel over the layer's input image,
    Z): loaded inducing patches, reset on a filter-size mismatch as the
    reference does, else k-means of sampled patches."""
    if 'Z' in params and np.asarray(params['Z']).shape[1] != f * f * C:
        for key in ('Z', 'q_mu', 'q_sqrt'):
            params.pop(key, None)
    kw = dict(dtype=dtype, device=device)
    view = FullView(input_size=(H, W), filter_size=f, feature_maps=C,
                    stride=stride)
    base = RBF.create(params.get('base_kernel/variance', 5.0),
                      params.get('base_kernel/lengthscales', 5.0), **kw)
    cls = ConvKernel if flags.last_kernel == 'conv' else AdditivePatchKernel
    kernel = cls.create(base, view, params.get('patch_weights'), **kw)
    if 'Z' in params:
        return kernel, _tensor(params['Z'], **kw)
    return kernel, _fresh_Z(H_X, i, M, f, generator, **kw)


def _rbf_last_layer(params, H_X, M, D, generator, dtype, device):
    """(ARD RBF over the D flattened inputs, Z).  A plain kernel's
    hyperparameters are stored under the un-prefixed 'variance' and
    'lengthscales' (gpflow's pathnames of a bare RBF, which the reference
    reads back); the prefixed names are the fallback.  Fresh inducing
    points are k-means++ of the flattened training inputs."""
    kw = dict(dtype=dtype, device=device)
    kernel = RBF.create(
        params.get('variance', params.get('base_kernel/variance', 5.0)),
        params.get('lengthscales',
                   params.get('base_kernel/lengthscales', 5.0)),
        ard_dim=D, **kw)
    if 'Z' in params:
        return kernel, _tensor(params['Z'], **kw)
    if H_X is None:
        raise ValueError('the last layer has no saved Z: pass the training '
                         'images to initialise it')
    return kernel, inducing_points_from_data(
        H_X.reshape(H_X.shape[0], -1), M, generator=generator, **kw)
