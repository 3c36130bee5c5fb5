"""Experiment assembly and serving (counterpart of :mod:`pyhgt_tpu.experiments`)."""
