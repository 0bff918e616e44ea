"""The measurement tools of the port (counterparts of the JAX repository's
``tools/roofline.py``, ``tools/bytes_audit.py``, ``tools/soak.py`` and
``tools/natgrad_digits.py``), each runnable as ``python -m
deepcgp_tpu_torch.tools.<name>`` on the card; ``main(argv, device='cpu')``
runs one on the CPU."""
