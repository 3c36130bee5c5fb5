"""Models (counterpart of :mod:`pyhgt_tpu.models`)."""
