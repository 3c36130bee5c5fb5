"""Tensor ops and kernels (counterpart of :mod:`pyhgt_tpu.ops`)."""
