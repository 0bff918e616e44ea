"""Image-patch extraction, im2col (counterpart of ``deepcgp_tpu/ops/patches.py``).

Patches run row-major over (out_h, out_w); elements within a patch run
row-major over (filter_h, filter_w, channel), channels fastest -- the order
of ``tf.extract_image_patches`` that stored inducing patches use.
:func:`transposed_patch_perm` and :func:`pixel_index` also describe the
transposed patch order (column-major over the output grid) of the
unfused last layer's extraction, ``ops.cuda_patches``.
"""

from __future__ import annotations

import torch


def out_size(in_size: int, filter_size: int, stride: int, dilation: int = 1) -> int:
    """VALID-padding output size."""
    eff = (filter_size - 1) * dilation + 1
    return (in_size - eff) // stride + 1


def extract_patches(NHWC_X: torch.Tensor, filter_size: int, stride: int = 1,
                    dilation: int = 1) -> torch.Tensor:
    """[N, H, W, C] -> [N, P, L] with P = Hout*Wout, L = fh*fw*C.

    One strided view [N, Hout, Wout, fh, fw, C] of the image, copied once
    into TF order (``F.unfold`` would order a patch (C, fh, fw) and, on the
    card, launch one kernel per image)."""
    X = NHWC_X.contiguous()
    N, H, W, C = X.shape
    f = filter_size
    Hout = out_size(H, f, stride, dilation)
    Wout = out_size(W, f, stride, dilation)
    sN, sH, sW, sC = X.stride()
    view = X.as_strided((N, Hout, Wout, f, f, C),
                        (sN, stride * sH, stride * sW, dilation * sH,
                         dilation * sW, sC))
    return view.reshape(N, Hout * Wout, f * f * C)


def transposed_patch_perm(Hout: int, Wout: int, device=None) -> torch.Tensor:
    """int64 [P]: ``patches_tp[:, i] == patches_tf[:, perm[i]]``.  Index i
    is the transposed (column-major) patch index i = ox * Hout + oy;
    perm[i] = oy * Wout + ox is its TF row-major position."""
    i = torch.arange(Hout * Wout, device=device)
    return (i % Hout) * Wout + i // Hout


def pixel_index(image_shape, filter_size: int, stride: int = 1,
                dilation: int = 1, transposed: bool = False,
                device=None) -> torch.Tensor:
    """int64 [P * L]: the flat (y, x, c) pixel of an [H, W, C] image that
    each element of its [P, L] patch matrix is read from, patches in TF
    order or, with ``transposed``, in transposed order."""
    H, W, C = image_shape
    f = filter_size
    Hout = out_size(H, f, stride, dilation)
    Wout = out_size(W, f, stride, dilation)
    p = torch.arange(Hout * Wout, device=device)
    if transposed:
        p = transposed_patch_perm(Hout, Wout, device)
    oy, ox = p // Wout, p % Wout
    l = torch.arange(f * f * C, device=device)
    fy, fx, c = l // (f * C), (l // C) % f, l % C
    y = oy[:, None] * stride + fy[None, :] * dilation
    x = ox[:, None] * stride + fx[None, :] * dilation
    return ((y * W + x) * C + c[None, :]).reshape(-1)
