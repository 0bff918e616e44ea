"""Views: patch geometry of a conv layer (counterpart of
``deepcgp_tpu/models/views.py``; ``RandomPartialView`` is not ported yet)."""

from __future__ import annotations

import dataclasses

import torch

from deepcgp_tpu_torch.ops.cuda_patches import tf_order_patches
from deepcgp_tpu_torch.ops.patches import out_size


@dataclasses.dataclass(frozen=True)
class FullView:
    """All patches of the image."""

    input_size: tuple  # (H, W)
    filter_size: int
    feature_maps: int
    stride: int = 1
    dilation: int = 1

    @property
    def patch_length(self) -> int:
        return self.feature_maps * self.filter_size * self.filter_size

    @property
    def out_image_height(self) -> int:
        return out_size(self.input_size[0], self.filter_size, self.stride,
                        self.dilation)

    @property
    def out_image_width(self) -> int:
        return out_size(self.input_size[1], self.filter_size, self.stride,
                        self.dilation)

    @property
    def patch_count(self) -> int:
        return self.out_image_height * self.out_image_width

    def extract_patches_NPL(self, NHWC_X: torch.Tensor) -> torch.Tensor:
        """[N, P, L]; its backward is K7 (``tf_order_patches``)."""
        return tf_order_patches(NHWC_X, self.filter_size, self.stride,
                               self.dilation)

    def mean_view(self, NHWC_X: torch.Tensor, NPL_patches) -> torch.Tensor:
        """Input handed to the mean function."""
        return NHWC_X
