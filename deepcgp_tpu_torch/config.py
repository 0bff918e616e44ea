"""Numeric configuration of the port, as constants.

The reference (kekeblom/DeepCGP) runs in float64 with an absolute jitter of
1e-3.  The port computes in float32 on the card and follows the dtype of its
parameters everywhere, so float64 runs on the CPU for the parity tests
through the same code.  The JAX package's environment switches are not
carried over: their defaults are the constants below and the kernel
choices in the ``ops`` modules.
"""

from __future__ import annotations

import torch

# Absolute diagonal jitter added to every Kuu (reference gpflowrc).
JITTER = 1e-3
FLOAT_TYPE = torch.float32
# Lower bound of the positive-parameter bijector (gpflow 1.x Log1pe).
POSITIVE_MINIMUM = 1e-6
# Gauss-Hermite points of the robust-max likelihood.
NUM_GAUSS_HERMITE_POINTS = 20

# Kuu self-grams feed a Cholesky.  TF32 keeps ~10 mantissa bits, whose error
# on an ill-conditioned gram outgrows the 1e-3 jitter and un-PSDs it -- the
# hazard the JAX package avoids by running those products at
# Precision.HIGHEST.  So every float32 product and convolution of the port
# runs in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card, and raises when
    there is none -- the port runs on the CPU only when asked to."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "the port's plain versions on the CPU")
    return torch.device('cuda')
