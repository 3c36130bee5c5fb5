"""Task heads' host side (counterpart of :mod:`pyhgt_tpu.tasks`)."""
