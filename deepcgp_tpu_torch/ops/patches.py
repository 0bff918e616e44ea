"""Image-patch extraction, im2col (counterpart of ``deepcgp_tpu/ops/patches.py``).

Patches run row-major over (out_h, out_w); elements within a patch run
row-major over (filter_h, filter_w, channel), channels fastest -- the order
of ``tf.extract_image_patches`` that stored inducing patches use.
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
