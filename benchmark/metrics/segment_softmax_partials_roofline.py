"""Kernels: ``segment_softmax_partials``' share of its roofline over the
traced steps (as ``live_partials_pair_roofline``)."""

from benchmark import roofline


def read(ctx):
    return roofline.share(ctx["trace"], "softmax", roofline.is_softmax)
