"""Host batch layout (counterpart of :mod:`pyhgt_tpu.sampling`)."""
