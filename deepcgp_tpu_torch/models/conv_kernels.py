"""Convolutional (patch-space) kernels (counterpart of
``deepcgp_tpu/models/conv_kernels.py``).

Patch weights are stored in TF patch order, as the snapshots hold them.
The patch-sum kernels extract patches in transposed patch order
(``ops.cuda_patches``, K6) and read their weights through the same
permutation (:meth:`AdditivePatchKernel._weights`): every consumer reduces
over P, and the order within a patch is TF's, so Z needs none.  The
last layer's (Kzx, Kdiag) pair takes the fused kernels (K4/K5) where their
geometry fits (``cuda_cross.fused_fits``) and this unfused route elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deepcgp_tpu_torch.config import JITTER
from deepcgp_tpu_torch.models.base_kernels import RBF, frozen_parameter
from deepcgp_tpu_torch.ops import cuda_cross, cuda_patches
from deepcgp_tpu_torch.ops.linalg import add_jitter
from deepcgp_tpu_torch.utils import profiling


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

    def Kuf(self, Z: torch.Tensor, PNL_patches: torch.Tensor) -> torch.Tensor:
        """[P, M, N]."""
        return self.Kuf_PNM(Z, PNL_patches).transpose(-1, -2)

    def Kff(self, PNL_patches: torch.Tensor) -> torch.Tensor:
        """[P, N, N]: the full covariance at each patch position."""
        return self.base_kernel.K(PNL_patches)

    def Kdiag(self, PNL_patches: torch.Tensor) -> torch.Tensor:
        """[P, N]."""
        return self.base_kernel.Kdiag(PNL_patches)


def _default_patch_weights(patch_count: int, patch_weights, dtype, device):
    if patch_weights is None or np.asarray(patch_weights).size != patch_count:
        patch_weights = np.ones(patch_count)
    return torch.tensor(np.asarray(patch_weights), dtype=dtype, device=device)


class AdditivePatchKernel(nn.Module):
    """K(x, x') = mean_p w_p k(x[p], x'[p]) over flattened images."""

    def __init__(self, base_kernel, patch_weights: torch.Tensor, view):
        super().__init__()
        self.base_kernel = base_kernel
        self.patch_weights = frozen_parameter(patch_weights)  # [P], TF order
        self.view = view
        # The TF position of each transposed-order patch (not saved).
        self.register_buffer('patch_perm', cuda_patches.transposed_patch_perm(
            view.out_image_height, view.out_image_width,
            patch_weights.device), persistent=False)

    @classmethod
    def create(cls, base_kernel, view, patch_weights=None,
               dtype=torch.float32, device=None):
        return cls(base_kernel, _default_patch_weights(
            view.patch_count, patch_weights, dtype, device), view)

    def _weights(self) -> torch.Tensor:
        """patch_weights [P] in the order :meth:`_patches` produces."""
        return self.patch_weights[self.patch_perm]

    def _patches(self, ND_X: torch.Tensor) -> torch.Tensor:
        """[N, P, L] in transposed patch order: one K6 launch, K7 in the
        backward when ``ND_X`` needs a gradient."""
        N = ND_X.shape[0]
        H, W = self.view.input_size
        NHWC = ND_X.reshape(N, H, W, self.view.feature_maps).contiguous()
        return cuda_patches.transposed_patches(
            NHWC, self.view.filter_size, self.view.stride, self.view.dilation)

    def Kzz(self, Z: torch.Tensor) -> torch.Tensor:
        return self.base_kernel.K(Z)

    def K(self, ND_X: torch.Tensor, ND_X2: torch.Tensor | None = None):
        """[N, N2]: the weighted mean of same-position patch grams."""
        P1 = self._patches(ND_X).transpose(0, 1)                # [P, N, L]
        if ND_X2 is None:
            PNN = self.base_kernel.K(P1)                        # [P, N, N]
        else:
            PNN = self.base_kernel.K(P1, self._patches(ND_X2).transpose(0, 1))
        return (PNN * self._weights()[:, None, None]).mean(0)

    def Kdiag(self, ND_X: torch.Tensor, patches=None) -> torch.Tensor:
        """[N]: mean_p w_p k(x[p], x[p]).  An RBF base's is the constant
        variance * mean(w), and ``patches`` is not read; any other base
        reads them (this kernel's extraction of ``ND_X``, made when not
        given)."""
        if not self._kdiag_needs_patches():
            v = self.base_kernel.variance * self.patch_weights.mean()
            return v.expand(ND_X.shape[0]).to(ND_X.dtype)
        if patches is None:
            patches = self._patches(ND_X)
        NP = self.base_kernel.Kdiag(patches)                    # [N, P]
        return (NP * self._weights()).mean(1)

    def _kdiag_needs_patches(self) -> bool:
        return not isinstance(self.base_kernel, RBF)

    def _cross(self, Z: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
        """[N, M] = sum_p w_p / P k(x[p], Z): the [N, P, M] base-kernel
        block, contracted with the weights by one batched product."""
        NPM = self.base_kernel.K(patches, Z[None])
        return torch.matmul(self._weights() / self.view.patch_count, NPM)

    def Kzx_NM_and_Kdiag(self, Z: torch.Tensor, ND_X: torch.Tensor):
        """(Kzx [N, M], Kdiag [N]): fused where the geometry fits (K4
        forward, K5 backward), else off one extraction (K6, and K7 in the
        backward) that Kdiag shares where it reads patches.  Each call
        counts its route in ``profiling.COUNTERS['cross route fused']`` or
        ``['cross route unfused']``."""
        if cuda_cross.fused_fits(self):
            profiling.COUNTERS['cross route fused'] += 1
            return cuda_cross.kzx_and_kdiag(self, Z, ND_X)
        profiling.COUNTERS['cross route unfused'] += 1
        patches = self._patches(ND_X)
        return self._cross(Z, patches), self.Kdiag(ND_X, patches)

    def Kzx_NM(self, Z: torch.Tensor, ND_X: torch.Tensor) -> torch.Tensor:
        """[N, M] = mean_p w_p k(x[p], Z)."""
        return self._cross(Z, self._patches(ND_X))

    def Kzx(self, Z: torch.Tensor, ND_X: torch.Tensor) -> torch.Tensor:
        return self.Kzx_NM(Z, ND_X).T


# The largest block of ConvKernel.K's [N1 P, N2 P] patch gram.  The base
# kernel holds up to three grams of a block at once (the distances, their
# scaled copy, the exponential), so a quarter of 1 GiB keeps the whole
# evaluation under 1 GiB.
GRAM_BLOCK_BYTES = 1 << 28


def gram_block_rows(pc: int, N2: int, itemsize: int,
                    limit: int = GRAM_BLOCK_BYTES) -> int:
    """Images of ND_X per block of :meth:`ConvKernel.K`: the most whose
    [rows P, N2 P] gram fits in ``limit`` bytes, at least one."""
    return max(1, limit // (itemsize * pc * N2 * pc))


class ConvKernel(AdditivePatchKernel):
    """Weighted double patch sum:
    K(x, x') = sum_pq w_p w_q k(x[p], x'[q]) / P^2."""

    def K(self, ND_X: torch.Tensor, ND_X2: torch.Tensor | None = None, *,
          block_rows: int | None = None):
        """[N1, N2], in blocks of ``block_rows`` images of ND_X (default:
        :func:`gram_block_rows`, so that no block of the [N1 P, N2 P]
        patch gram exceeds 256 MiB and the evaluation stays under 1 GiB;
        the whole gram at MNIST's P = 576 and N = 128 would take 21.7 GB).
        Each block is the base kernel of its patches against all of
        ND_X2's, weighted and summed over q, then over p: every entry sums
        the same P x P terms in the same order whatever the blocking.  A self-gram's patches are centred
        first on their (gradient-free) mean, as the base kernel centres a
        self-gram: it is factorized in full-covariance sampling."""
        pc = self.view.patch_count
        L = self.view.patch_length
        p1 = self._patches(ND_X).reshape(-1, L)                 # [N1*P, L]
        if ND_X2 is None:
            p1 = p1 - p1.mean(0, keepdim=True).detach()
            p2 = p1
        else:
            p2 = self._patches(ND_X2).reshape(-1, L)
        N1 = ND_X.shape[0]
        N2 = p2.shape[0] // pc
        w = self._weights()
        if block_rows is None:
            block_rows = gram_block_rows(pc, N2, p1.element_size())
        out = []
        for n0 in range(0, N1, block_rows):
            n = min(block_rows, N1 - n0)
            blk = self.base_kernel.K(p1[n0 * pc:(n0 + n) * pc], p2)
            blk = (blk.reshape(n, pc, N2, pc) * w).sum(-1)      # [n, P, N2]
            out.append((blk * w[:, None]).sum(1))
        return torch.cat(out) / (pc * pc)

    def Kdiag(self, ND_X: torch.Tensor, patches=None) -> torch.Tensor:
        """[N]: w^T k(x[p], x[q]) w / P^2 over each image's own patches,
        from ``patches`` (this kernel's extraction of ``ND_X``) when given.
        The gram takes explicit X2, as the JAX package's does: it is only
        summed, never factorized, so it needs no centring."""
        if patches is None:
            patches = self._patches(ND_X)
        NPP = self.base_kernel.K(patches, patches)              # [N, P, P]
        w = self._weights()
        pc = self.view.patch_count
        return torch.matmul(torch.matmul(NPP, w), w) / (pc * pc)
