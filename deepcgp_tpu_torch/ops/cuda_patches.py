"""Patch extraction in transposed patch order and its adjoint: the
extraction of the unfused last-layer route.

Counterpart of ``deepcgp_tpu/ops/pallas_patches.py``.  Two kernels of
``csrc/patches.cu``:

* :func:`extract_patches_transposed` (K6): images [N, H, W, C] -> patches
  [N, P, L], P in transposed order p = ox * Hout + oy, the elements of a
  patch in TF order (dy, dx, c);
* :func:`col2im_transposed` (K7): its adjoint, [N, P, L] -> [N, H, W, C].

K6 stages the band of pixels each block's piece of the output reads and
streams the piece out in vectors; :func:`extract_plan` is its split of the
work, in Python, for the tests and the card's check of the launcher's own.

Only the patch order differs from ``ops.patches.extract_patches``: the
[L]-indexed parameters (inducing patches Z, ARD lengthscales) need no
permutation, and a [P]-indexed one (patch weights) is gathered with
:func:`transposed_patch_perm`.  :func:`transposed_patches` is the
``torch.autograd.Function`` that ties the two together, as JAX's custom VJP
does; K7 runs only when the image needs a gradient.  :func:`tf_order_patches`
is the hidden layers' extraction: the TF-order strided copy forward, K7 on
the cotangent gathered into transposed order backward, in place of
autograd's ``index_add_`` (an atomic scatter on the card).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepcgp_tpu_torch.ops import cuda_build
from deepcgp_tpu_torch.ops.patches import (extract_patches, out_size,
                                           pixel_index, transposed_patch_perm)


def _out_grid(image_shape, filter_size, stride, dilation):
    H, W, _ = image_shape
    return (out_size(H, filter_size, stride, dilation),
            out_size(W, filter_size, stride, dilation))


def extract_patches_transposed_plain(NHWC_X, filter_size, stride=1,
                                     dilation=1):
    """Plain PyTorch version of K6: the TF-order im2col, its patches
    gathered into transposed order."""
    Hout, Wout = _out_grid(NHWC_X.shape[1:], filter_size, stride, dilation)
    perm = transposed_patch_perm(Hout, Wout, NHWC_X.device)
    return extract_patches(NHWC_X, filter_size, stride, dilation)[:, perm]


def col2im_transposed_plain(g, image_shape, filter_size, stride=1,
                            dilation=1):
    """Plain PyTorch version of K7: ``index_add_`` of every patch element
    of g [N, P, L] (transposed order) into its pixel of [N, H, W, C]."""
    N = g.shape[0]
    H, W, C = image_shape
    idx = pixel_index(image_shape, filter_size, stride, dilation,
                      transposed=True, device=g.device)
    out = g.new_zeros(N, H * W * C)
    out.index_add_(1, idx, g.reshape(N, -1))
    return out.reshape(N, H, W, C)


# K6's launch constants (csrc/patches.cu): threads a block, the most a
# block stages, and the tasks an SM it aims for.
THREADS = 256
BAND_BYTES = 48 * 1024
TASKS_PER_SM = 4


def _ceil_div(a, b):
    return -(-a // b)


def vector_width(C, *addresses):
    """Floats a vector in K6 and K7: the largest of 4, 2, 1 that divides C
    and the byte alignment of every address."""
    for v in (4, 2):
        if C % v == 0 and all(a % (4 * v) == 0 for a in addresses):
            return v
    return 1


def extract_plan(N, image_shape, filter_size, stride, dilation, sms, vec):
    """K6's split of N images (csrc/patches.cu ``extract_plan``): a task
    is ``kc`` output columns (with ``kr`` = Hout) or ``kr`` rows of one
    column (``kc`` = 1), task r of image n writing the output piece from
    patch (r // tasks_y * kc) * Hout + r % tasks_y * kr; ``bh`` x ``bw``
    is its staged band (``staged`` 0: read from the image instead), and
    ``step`` the (ox, oy, dy, dx, c) that one pass of THREADS vectors adds."""
    H, W, C = image_shape
    f, s, d = filter_size, stride, dilation
    Hout, Wout = _out_grid(image_shape, f, s, d)
    reach = (f - 1) * d + 1

    def band_bytes(kc, kr):
        return ((kr - 1) * s + reach) * ((kc - 1) * s + reach) * C * 4

    want = _ceil_div(TASKS_PER_SM * sms, N)
    if want <= Wout:
        kc, kr = _ceil_div(Wout, want), Hout
    else:
        kc, kr = 1, _ceil_div(Hout, min(Hout, _ceil_div(want, Wout)))
    sc, sr = kc, kr
    while band_bytes(sc, sr) > BAND_BYTES and (sc > 1 or sr > 1):
        if sc > 1:
            sc = (sc + 1) // 2
        else:
            sr = (sr + 1) // 2
    staged = band_bytes(sc, sr) <= BAND_BYTES
    bh = bw = 0
    if staged:
        kc, kr = sc, sr
        bh, bw = (kr - 1) * s + reach, (kc - 1) * s + reach
    tasks_y = _ceil_div(Hout, kr)
    Cv = C // vec
    dp, dl = divmod(THREADS, f * f * Cv)
    return dict(sms=sms, vec=vec, kc=kc, kr=kr, tasks_y=tasks_y,
                tasks_per_image=_ceil_div(Wout, kc) * tasks_y, bh=bh, bw=bw,
                staged=int(staged), tasks=N * _ceil_div(Wout, kc) * tasks_y,
                step=(dp // Hout, dp % Hout, dl // (f * Cv), dl % (f * Cv) // Cv,
                      dl % Cv))


def _check(what, x, ndim):
    """True for a CPU tensor (the plain version runs); for a CUDA tensor,
    raise on anything the kernel does not take and return False."""
    if x.device.type == 'cpu':
        return True
    if x.device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {x.device}')
    if x.dtype != torch.float32:
        raise TypeError(f'{what}: float32 only, got {x.dtype}')
    if x.ndim != ndim:
        raise ValueError(f'{what}: need a {ndim}-d tensor, got {tuple(x.shape)}')
    if not x.is_contiguous():
        raise ValueError(f'{what}: input must be contiguous')
    return False


def _grid(what, image_shape, filter_size, stride, dilation):
    """(Hout, Wout) of a geometry the kernels take; raises where no patch
    fits the image."""
    Hout, Wout = _out_grid(image_shape, filter_size, stride, dilation)
    if (min(filter_size, stride, dilation, image_shape[2]) < 1
            or Hout < 1 or Wout < 1):
        raise ValueError(f'{what}: filter {filter_size}, stride {stride}, '
                         f'dilation {dilation} do not fit an image '
                         f'{tuple(image_shape)}')
    return Hout, Wout


def _launch(what, src, out, image_shape, filter_size, stride, dilation,
            grid):
    fn = cuda_build.function('patches', what,
                             [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                             + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(src.device).cuda_stream
    cuda_build.check(fn(src.data_ptr(), out.data_ptr(), src.shape[0],
                        *image_shape, filter_size, stride, dilation, *grid,
                        stream), what)


def extract_patches_transposed(NHWC_X, filter_size, stride=1, dilation=1):
    """[N, H, W, C] -> [N, P, L] in transposed patch order.

    A CUDA tensor launches K6 (float32, contiguous) or raises; a CPU tensor
    takes :func:`extract_patches_transposed_plain`."""
    what = 'extract_patches_transposed'
    if _check(what, NHWC_X, 4):
        return extract_patches_transposed_plain(NHWC_X, filter_size, stride,
                                                dilation)
    image_shape = tuple(NHWC_X.shape[1:])
    grid = _grid(what, image_shape, filter_size, stride, dilation)
    out = torch.empty(NHWC_X.shape[0], grid[0] * grid[1],
                      filter_size * filter_size * image_shape[2],
                      dtype=NHWC_X.dtype, device=NHWC_X.device)
    _launch(what, NHWC_X, out, image_shape, filter_size, stride, dilation,
            grid)
    extract_patches_transposed.launches += 1
    return out


extract_patches_transposed.launches = 0


def col2im_transposed(g, image_shape, filter_size, stride=1, dilation=1):
    """Adjoint of :func:`extract_patches_transposed`: g [N, P, L] ->
    [N, H, W, C] for ``image_shape`` (H, W, C), summed in float32.

    A CUDA tensor launches K7 (float32, contiguous, [N, P, L] of the
    geometry) or raises; a CPU tensor takes :func:`col2im_transposed_plain`."""
    what = 'col2im_transposed'
    image_shape = tuple(image_shape)
    if _check(what, g, 3):
        return col2im_transposed_plain(g, image_shape, filter_size, stride,
                                       dilation)
    grid = _grid(what, image_shape, filter_size, stride, dilation)
    P, L = grid[0] * grid[1], filter_size * filter_size * image_shape[2]
    if tuple(g.shape[1:]) != (P, L):
        raise ValueError(f'{what}: g {tuple(g.shape)} is not [N, {P}, {L}]')
    out = torch.empty(g.shape[0], *image_shape, dtype=g.dtype, device=g.device)
    _launch(what, g, out, image_shape, filter_size, stride, dilation, grid)
    col2im_transposed.launches += 1
    return out


col2im_transposed.launches = 0


class _TransposedPatches(torch.autograd.Function):
    """K6 forward, K7 backward.  Saves nothing but the geometry: the
    extraction is linear."""

    @staticmethod
    def forward(ctx, NHWC_X, filter_size, stride, dilation):
        ctx.geometry = (tuple(NHWC_X.shape[1:]), filter_size, stride, dilation)
        return extract_patches_transposed(NHWC_X, filter_size, stride, dilation)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        image_shape, filter_size, stride, dilation = ctx.geometry
        return (col2im_transposed(g.contiguous(), image_shape, filter_size,
                                  stride, dilation), None, None, None)


def transposed_patches(NHWC_X, filter_size, stride=1, dilation=1):
    """Differentiable :func:`extract_patches_transposed`: K6 forward, K7
    backward (the plain versions of both on CPU tensors)."""
    return _TransposedPatches.apply(NHWC_X, filter_size, stride, dilation)


@functools.lru_cache(maxsize=None)
def _patch_perm(Hout, Wout, device):
    return transposed_patch_perm(Hout, Wout, device)


class _TFOrderPatches(torch.autograd.Function):
    """``patches.extract_patches`` (a strided copy) forward, K7 backward on
    the cotangent gathered into transposed order: no element is summed
    with atomics, so the gradient does not depend on the order in which
    the card's threads arrive."""

    @staticmethod
    def forward(ctx, NHWC_X, filter_size, stride, dilation):
        ctx.geometry = (tuple(NHWC_X.shape[1:]), filter_size, stride, dilation)
        return extract_patches(NHWC_X, filter_size, stride, dilation)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        perm = _patch_perm(*_out_grid(*ctx.geometry), g.device)
        return (col2im_transposed(g.index_select(1, perm), *ctx.geometry),
                None, None, None)


def tf_order_patches(NHWC_X, filter_size, stride=1, dilation=1):
    """Differentiable ``patches.extract_patches`` ([N, P, L], TF patch
    order) whose backward is K7 (its plain version on CPU tensors)."""
    return _TFOrderPatches.apply(NHWC_X, filter_size, stride, dilation)
