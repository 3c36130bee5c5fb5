"""Graph schema (counterpart of :mod:`pyhgt_tpu.graph`)."""
