"""Datasets (counterpart of :mod:`pyhgt_tpu.datasets`)."""
