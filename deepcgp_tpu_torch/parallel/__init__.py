"""Multi-process training and serving on ``torch.distributed``
(counterpart of ``deepcgp_tpu/parallel/``)."""
