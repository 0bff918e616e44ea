"""Convolutional (patch-space) kernels (counterpart of
``deepcgp_tpu/models/conv_kernels.py``, the parts the flagship needs).

Patch weights are stored in TF patch order, as the snapshots hold them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deepcgp_tpu_torch.config import JITTER
from deepcgp_tpu_torch.models.base_kernels import frozen_parameter
from deepcgp_tpu_torch.ops.linalg import add_jitter


class MultiOutputConvKernel:
    """Shared base kernel evaluated independently at each patch position."""

    def __init__(self, base_kernel, patch_count: int):
        self.base_kernel = base_kernel
        self.patch_count = patch_count

    def Kuu(self, Z: torch.Tensor) -> torch.Tensor:
        """[M, M] = K(Z) + jitter I."""
        return add_jitter(self.base_kernel.K(Z), JITTER)

    def Kuf_PNM(self, Z: torch.Tensor, PNL_patches: torch.Tensor) -> torch.Tensor:
        """[P, N, M]."""
        return self.base_kernel.K(PNL_patches, Z[None])

    def Kdiag(self, PNL_patches: torch.Tensor) -> torch.Tensor:
        """[P, N]."""
        return self.base_kernel.Kdiag(PNL_patches)


def _default_patch_weights(patch_count: int, patch_weights, dtype, device):
    if patch_weights is None or np.asarray(patch_weights).size != patch_count:
        patch_weights = np.ones(patch_count)
    return torch.as_tensor(np.asarray(patch_weights), dtype=dtype, device=device)


class AdditivePatchKernel(nn.Module):
    """K(x, x') = mean_p w_p k(x[p], x'[p]) over flattened images."""

    def __init__(self, base_kernel, patch_weights: torch.Tensor, view):
        super().__init__()
        self.base_kernel = base_kernel
        self.patch_weights = frozen_parameter(patch_weights)  # [P]
        self.view = view

    @classmethod
    def create(cls, base_kernel, view, patch_weights=None,
               dtype=torch.float32, device=None):
        return cls(base_kernel, _default_patch_weights(
            view.patch_count, patch_weights, dtype, device), view)

    def Kzz(self, Z: torch.Tensor) -> torch.Tensor:
        return self.base_kernel.K(Z)

    def Kdiag(self, ND_X: torch.Tensor) -> torch.Tensor:
        """RBF Kdiag is the constant variance * mean(w)."""
        v = self.base_kernel.variance * self.patch_weights.mean()
        return v.expand(ND_X.shape[0]).to(ND_X.dtype)

    def Kzx_NM_and_Kdiag(self, Z: torch.Tensor, ND_X: torch.Tensor):
        """(Kzx [N, M], Kdiag [N]) through the fused CUDA kernel (K4
        forward, K5 backward)."""
        from deepcgp_tpu_torch.ops import cuda_cross
        return cuda_cross.kzx_and_kdiag(self, Z, ND_X)


class ConvKernel(AdditivePatchKernel):
    """Weighted double patch sum:
    K(x, x') = sum_pq w_p w_q k(x[p], x'[q]) / P^2."""

    def Kdiag(self, ND_X: torch.Tensor) -> torch.Tensor:
        """[N]: the weighted gram of each image's own patches.  The model
        gets it from the fused kernel with Kzx; this is the plain form for
        callers that need Kdiag alone."""
        N = ND_X.shape[0]
        H, W = self.view.input_size
        patches = self.view.extract_patches_NPL(
            ND_X.reshape(N, H, W, self.view.feature_maps))
        NPP = self.base_kernel.K(patches, patches)             # [N, P, P]
        w = self.patch_weights
        P = self.view.patch_count
        return (NPP * (w[:, None] * w[None, :])).sum((1, 2)) / (P * P)
