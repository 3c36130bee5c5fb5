"""Kernels: ``live_partials_pair``'s share of its roofline over the traced
steps: the least time its launches' bytes need at the card's memory rate
(``benchmark.kernel_bytes``) over the device time of the kernels that
implement it (the pair walks of ``csrc/pair_walk.cuh``). Nothing when the
launches the program counted are not those the batches imply."""

from benchmark import roofline


def read(ctx):
    return roofline.share(ctx["trace"], "pair", roofline.is_pair_walk)
