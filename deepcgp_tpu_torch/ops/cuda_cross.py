"""Fused patch extraction -> RBF cross-covariance of the last layer.

Counterpart of the forward of ``deepcgp_tpu/ops/pallas_cross.py``:
(Kzx [N, M], Kdiag [N]) of a patch-sum kernel with a scalar-lengthscale
RBF base over a FullView, straight from the images, in one launch of
``csrc/conv_rbf_cross.cu``.  The [N, P, L] patch tensor and the [N, P, M]
kernel matrix never reach device memory.
"""

from __future__ import annotations

import ctypes

import torch

from deepcgp_tpu_torch.ops import cuda_build
from deepcgp_tpu_torch.ops.patches import extract_patches, out_size

# Dynamic shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232448
# Inducing columns per kernel tile (kMT in csrc/conv_rbf_cross.cu).
_MT = 128


def smem_bytes(P: int, L: int) -> int:
    """Shared memory of one kernel block: the transposed patch matrix
    [L, Ppad] plus norm and reduction buffers (mirror of
    ``conv_rbf_cross_smem_bytes`` in the source)."""
    Ppad = -(-P // 8) * 8
    warps = min(Ppad // 8, 8)
    return 4 * (L * Ppad + Ppad + _MT + warps * _MT)


def conv_rbf_cross_plain(NHWC_X, Z, variance, gamma, u, wkd, filter_size,
                         stride=1, dilation=1, with_kdiag=True):
    """Plain PyTorch version of the kernel: im2col, distances, exp and the
    patch sums, materialized.  ``u`` and ``wkd`` are [P] in TF patch
    order; Kdiag is zeros unless ``with_kdiag``."""
    patches = extract_patches(NHWC_X, filter_size, stride, dilation)  # [N,P,L]
    P = patches.shape[1]
    pn = patches.square().sum(-1)                                     # [N, P]
    zn = Z.square().sum(-1)                                           # [M]
    D = pn[:, :, None] + zn - 2.0 * (patches @ Z.T)
    K = variance * torch.exp(gamma * D.clamp_min(0.0))
    kzx = torch.einsum('npm,p->nm', K, u)
    if not with_kdiag:
        return kzx, torch.zeros_like(kzx[:, 0])
    G = patches @ patches.transpose(1, 2)
    E = pn[:, :, None] + pn[:, None, :] - 2.0 * G
    Kd = variance * torch.exp(gamma * E.clamp_min(0.0))
    W2 = wkd[:, None] * wkd[None, :] / (P * P)
    return kzx, (Kd * W2).sum((1, 2))


# (Z, Z._version, Zt) of the last inducing matrix launched: a served model
# passes the same Z on every call, so its transposed copy is built once.
_zt_cache = None


def _padded_zt(Z):
    """Z^T [L, Mpad], zero-padded to whole column tiles, as the kernel
    reads it; rebuilt when Z is another tensor or was written in place."""
    global _zt_cache
    hit = _zt_cache
    if hit is not None and hit[0] is Z and hit[1] == Z._version:
        return hit[2]
    M, L = Z.shape
    Zt = torch.zeros(L, -(-M // _MT) * _MT, dtype=Z.dtype, device=Z.device)
    Zt[:, :M] = Z.T
    _zt_cache = (Z, Z._version, Zt)
    return Zt


def _launch(NHWC_X, Z, scal, u, wkd, filter_size, stride, dilation,
            with_kdiag):
    N, H, W, C = NHWC_X.shape
    M = Z.shape[0]
    Zt = _padded_zt(Z)
    Mpad = Zt.shape[1]
    kzx = torch.empty(N, M, dtype=Z.dtype, device=Z.device)
    kd = torch.empty(N, dtype=Z.dtype, device=Z.device)
    fn = cuda_build.function(
        'conv_rbf_cross', 'conv_rbf_cross',
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(Z.device).cuda_stream
    cuda_build.check(fn(NHWC_X.data_ptr(), Zt.data_ptr(), scal.data_ptr(),
                        u.data_ptr(), wkd.data_ptr(), kzx.data_ptr(),
                        kd.data_ptr(), N, H, W, C, filter_size, stride,
                        dilation, M, Mpad, int(with_kdiag), stream),
                     'conv_rbf_cross')
    conv_rbf_cross.launches += 1
    return kzx, kd


def conv_rbf_cross(NHWC_X, Z, variance, gamma, u, wkd, filter_size,
                   stride=1, dilation=1, with_kdiag=True):
    """(Kzx [N, M], Kdiag [N]) of images NHWC_X [N, H, W, C] against
    inducing patches Z [M, f*f*C] (TF element order).  ``variance`` and
    ``gamma`` = -0.5 / lengthscale^2 are scalar tensors; ``u`` = w / P and
    ``wkd`` = w are [P] in TF patch order.

    CUDA tensors launch the kernel (float32, contiguous, geometry within
    one block's shared memory) or raise; CPU tensors take
    :func:`conv_rbf_cross_plain`."""
    if NHWC_X.device.type == 'cpu':
        return conv_rbf_cross_plain(NHWC_X, Z, variance, gamma, u, wkd,
                                    filter_size, stride, dilation, with_kdiag)
    if NHWC_X.device.type != 'cuda':
        raise ValueError(f'conv_rbf_cross: unsupported device {NHWC_X.device}')
    N, H, W, C = NHWC_X.shape
    Hout = out_size(H, filter_size, stride, dilation)
    Wout = out_size(W, filter_size, stride, dilation)
    P, L = Hout * Wout, filter_size * filter_size * C
    tensors = dict(NHWC_X=NHWC_X, Z=Z, u=u, wkd=wkd)
    for name, t in tensors.items():
        if t.device != NHWC_X.device:
            raise ValueError(f'conv_rbf_cross: {name} on {t.device}')
        if t.dtype != torch.float32:
            raise TypeError(f'conv_rbf_cross: float32 only, {name} is {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'conv_rbf_cross: {name} must be contiguous')
    if Z.ndim != 2 or Z.shape[1] != L or u.shape != (P,) or wkd.shape != (P,):
        raise ValueError(
            f'conv_rbf_cross: Z {tuple(Z.shape)}, u {tuple(u.shape)}, wkd '
            f'{tuple(wkd.shape)} do not fit P={P}, L={L}')
    if P < 1 or smem_bytes(P, L) > SMEM_LIMIT:
        raise ValueError(f'conv_rbf_cross: P={P}, L={L} does not fit one block')
    scal = torch.stack([variance, gamma]).to(Z.device, torch.float32)
    return _launch(NHWC_X, Z, scal, u, wkd, filter_size, stride, dilation,
                   with_kdiag)


conv_rbf_cross.launches = 0


def supported(kernel) -> bool:
    """Whether ``kernel`` (a patch-sum kernel) evaluates through the fused
    path: scalar-lengthscale RBF base over a FullView whose patches fit one
    block's shared memory.  Mirrors ``pallas_cross.kernel_supported``; the
    CUDA kernel takes any batch size, so there is no block rule."""
    from deepcgp_tpu_torch.models.base_kernels import RBF
    from deepcgp_tpu_torch.models.conv_kernels import AdditivePatchKernel
    from deepcgp_tpu_torch.models.views import FullView
    if not isinstance(kernel, AdditivePatchKernel):
        return False
    view = kernel.view
    base = kernel.base_kernel
    return (isinstance(view, FullView) and isinstance(base, RBF)
            and base.raw_lengthscales.ndim == 0
            and smem_bytes(view.patch_count, view.patch_length) <= SMEM_LIMIT)


def kzx_and_kdiag(kernel, Z, ND_X):
    """The fused evaluation of ``kernel.Kzx_NM_and_Kdiag(Z, ND_X)``.

    ConvKernel: Kdiag is the weighted double patch sum from the kernel's
    in-block gram.  AdditivePatchKernel: the RBF Kdiag is the constant
    variance * mean(w), computed outside, and the kernel skips its gram."""
    from deepcgp_tpu_torch.models.conv_kernels import ConvKernel
    if not supported(kernel):
        raise NotImplementedError(
            'the fused cross-covariance takes a scalar-lengthscale RBF over a '
            'FullView that fits shared memory; the unfused path (K6, ROADMAP '
            'queue B) is not ported yet')
    view = kernel.view
    base = kernel.base_kernel
    N = ND_X.shape[0]
    H, W = view.input_size
    NHWC = ND_X.reshape(N, H, W, view.feature_maps)
    w = kernel.patch_weights
    with_kdiag = isinstance(kernel, ConvKernel)
    gamma = -0.5 / base.lengthscales.square()
    kzx, kdiag = conv_rbf_cross(NHWC, Z, base.variance, gamma,
                                w / view.patch_count, w, view.filter_size,
                                view.stride, view.dilation, with_kdiag)
    if not with_kdiag:
        kdiag = kernel.Kdiag(ND_X)
    return kzx, kdiag
