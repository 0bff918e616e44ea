"""PyTorch/CUDA port of deepcgp_tpu for one NVIDIA H100.

Same module layout as the JAX package; every TPU kernel on the ported path
is a CUDA kernel under ``csrc/``, built at first use.  Entry points run on
the card unless the caller passes ``device='cpu'``.
"""
