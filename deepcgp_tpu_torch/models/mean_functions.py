"""Mean functions (counterpart of ``deepcgp_tpu/models/mean_functions.py``).

The conv means are the "identity/residual" mean of ``--identity-mean``: a
frozen VALID conv2d whose delta filter copies the centre pixel of each
patch, so a hidden layer's GP models the residual around an identity map.
``PatchwiseConv2d`` is the partial views' mean, the same delta filter
applied to patches already extracted.  The filter is a buffer, never a
parameter: the trainer trains every parameter of the model, and the JAX
package freezes the filter by name.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class Zero:
    """Zero mean; broadcasts against [N, O]."""

    def __init__(self, output_dim: int = 1):
        self.output_dim = output_dim

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        return X.new_zeros((X.shape[0], 1))


def _identity_filter(filter_size: int, fm_in: int, fm_out: int,
                     all_channels: bool) -> np.ndarray:
    """Delta filter [fh, fw, in, out]: the centre tap of every (in, out)
    channel pair with ``all_channels``, else of (0, 0) alone."""
    filt = np.zeros((filter_size, filter_size, fm_in, fm_out))
    c = filter_size // 2
    if all_channels:
        filt[c, c, :, :] = 1.0
    else:
        filt[c, c, 0, 0] = 1.0
    return filt


class Conv2dMean(nn.Module):
    """conv2d (VALID) of NHWC images, flattened NHWC to [N, Hout*Wout*out]:
    a hidden layer's (P, R) output layout.  The filter is zero off its
    centre tap (``create`` builds no other), so the conv is the strided
    centre pixels times that tap, [in, out].  For ``--identity-mean``'s
    delta (channel 0 to map 0) every product but one is a zero, so the
    result is exact for finite inputs; unlike cuDNN's backward to the
    input, the backward never sums with atomics."""

    def __init__(self, conv_filter: torch.Tensor, stride: int = 1):
        super().__init__()
        c = conv_filter.shape[0] // 2
        off_centre = conv_filter.clone()
        off_centre[c, c] = 0
        if off_centre.any():
            raise ValueError('Conv2dMean: the filter is not zero off its '
                             'centre tap')
        self.register_buffer('conv_filter', conv_filter)  # [fh, fw, in, out]
        self.stride = stride

    @classmethod
    def create(cls, filter_size: int, feature_maps_in: int,
               feature_maps_out: int = 1, stride: int = 1,
               identity: bool = False, dtype=torch.float32, device=None):
        filt = _identity_filter(filter_size, feature_maps_in,
                                feature_maps_out, identity)
        return cls(torch.as_tensor(filt, dtype=dtype, device=device), stride)

    def conv(self, NHWC_X: torch.Tensor) -> torch.Tensor:
        """[N, H, W, in] -> [N, Hout, Wout, out]."""
        f, s = self.conv_filter.shape[0], self.stride
        c = f // 2
        Hout = (NHWC_X.shape[1] - f) // s + 1
        Wout = (NHWC_X.shape[2] - f) // s + 1
        centre = NHWC_X[:, c:c + s * (Hout - 1) + 1:s,
                        c:c + s * (Wout - 1) + 1:s]
        return centre @ self.conv_filter[c, c].to(NHWC_X.dtype)

    def forward(self, NHWC_X: torch.Tensor) -> torch.Tensor:
        out = self.conv(NHWC_X)
        return out.reshape(out.shape[0], -1)


class IdentityConv2dMean(Conv2dMean):
    """Centre-pixel copy across every channel pair, NHWC output."""

    @classmethod
    def create(cls, filter_size: int, feature_maps_in: int,
               feature_maps_out: int = 1, stride: int = 1,
               dtype=torch.float32, device=None):
        return super().create(filter_size, feature_maps_in, feature_maps_out,
                              stride, identity=True, dtype=dtype,
                              device=device)

    def forward(self, NHWC_X: torch.Tensor) -> torch.Tensor:
        return self.conv(NHWC_X)


class PatchwiseConv2d(nn.Module):
    """Conv2dMean's product over patches already extracted, for partial
    views: [N, P, L] patches (TF order within a patch) times the filter
    [fh, fw, in, 1] flattened to [L] -> [N, P]."""

    def __init__(self, conv_filter: torch.Tensor):
        super().__init__()
        self.register_buffer('conv_filter', conv_filter)  # [fh, fw, in, 1]

    @classmethod
    def create(cls, filter_size: int, feature_maps_in: int,
               dtype=torch.float32, device=None):
        filt = _identity_filter(filter_size, feature_maps_in, 1, False)
        return cls(torch.as_tensor(filt, dtype=dtype, device=device))

    def forward(self, NPL_patches: torch.Tensor) -> torch.Tensor:
        w = self.conv_filter.reshape(-1).to(NPL_patches.dtype)
        return NPL_patches @ w
