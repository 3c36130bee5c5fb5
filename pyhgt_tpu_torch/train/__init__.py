"""Losses, the train step, optimizers and schedules (counterpart of :mod:`pyhgt_tpu.train`)."""
