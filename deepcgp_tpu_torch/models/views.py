"""Views: patch geometry of a conv layer (counterpart of
``deepcgp_tpu/models/views.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deepcgp_tpu_torch.ops.cuda_patches import tf_order_patches
from deepcgp_tpu_torch.ops.patches import out_size

# (patch_indices, device) -> the partial view's indices as a tensor.
_INDICES: dict = {}


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


@dataclasses.dataclass(frozen=True)
class RandomPartialView:
    """A fixed random subset of ``patch_count`` stride-1 patch positions,
    whose output is read as a sqrt(patch_count)-square image.

    ``patch_indices`` are flat indices into the full stride-1 patch grid,
    sorted by (y, x).  They are drawn as the JAX package draws them:
    ``np.random.RandomState(seed)``, each start y then x uniform over
    [0, size - filter) (the last start is never drawn), until
    ``patch_count`` distinct positions are taken; so a seed gives the
    same positions in both packages."""

    input_size: tuple
    filter_size: int
    feature_maps: int
    patch_count: int
    patch_indices: tuple = None  # flat indices, filled by __post_init__
    seed: int = 0

    def __post_init__(self):
        if self.patch_indices is not None:
            return
        rng = np.random.RandomState(self.seed)
        H, W = self.input_size
        f = self.filter_size
        available = max(0, H - f) * max(0, W - f)
        if self.patch_count > available:
            raise ValueError(
                f"patch_count={self.patch_count} exceeds the "
                f"{available} distinct sampleable positions of a "
                f"{H}x{W} image with filter {f} (the sampler draws "
                "starts from [0, size - filter))")
        taken = set()
        while len(taken) < self.patch_count:
            y = rng.choice(np.arange(0, H - f))
            x = rng.choice(np.arange(0, W - f))
            taken.add((int(y), int(x)))
        full_w = out_size(W, f, 1)
        object.__setattr__(self, 'patch_indices',
                           tuple(y * full_w + x for (y, x) in sorted(taken)))

    @property
    def stride(self) -> int:
        return 1

    @property
    def dilation(self) -> int:
        return 1

    @property
    def patch_length(self) -> int:
        return self.feature_maps * self.filter_size * self.filter_size

    @property
    def out_image_height(self) -> int:
        return int(np.sqrt(self.patch_count))

    @property
    def out_image_width(self) -> int:
        return int(np.sqrt(self.patch_count))

    def extract_patches_NPL(self, NHWC_X: torch.Tensor) -> torch.Tensor:
        """[N, patch_count, L]: every stride-1 patch (``tf_order_patches``,
        K7 its backward), then the chosen positions by ``index_select``,
        whose backward scatters to unique indices, so it is
        deterministic."""
        full = tf_order_patches(NHWC_X, self.filter_size, 1, 1)
        key = (self.patch_indices, NHWC_X.device)
        if key not in _INDICES:
            # Copied to the device once: a CUDA graph capture cannot hold
            # a copy from the host.
            _INDICES[key] = torch.as_tensor(self.patch_indices,
                                            dtype=torch.int64,
                                            device=NHWC_X.device)
        return full.index_select(1, _INDICES[key])

    def mean_view(self, NHWC_X: torch.Tensor, NPL_patches) -> torch.Tensor:
        """A partial view hands the mean function its selected patches."""
        return NPL_patches
