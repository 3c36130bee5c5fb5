"""Utilities (counterpart of :mod:`pyhgt_tpu.utils`)."""
