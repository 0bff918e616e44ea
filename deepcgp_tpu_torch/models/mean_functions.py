"""Mean functions (counterpart of ``deepcgp_tpu/models/mean_functions.py``;
``Conv2dMean`` and ``PatchwiseConv2d`` are not ported yet)."""

from __future__ import annotations

import torch


class Zero:
    """Zero mean; broadcasts against [N, O]."""

    def __init__(self, output_dim: int = 1):
        self.output_dim = output_dim

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        return X.new_zeros((X.shape[0], 1))
