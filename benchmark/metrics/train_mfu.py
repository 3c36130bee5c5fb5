"""Train step: the least time the window's model FLOPs need at the peaks
of the precisions the configuration states (``benchmark.flops``,
``benchmark.peaks``), over the window's time, in percent."""

from benchmark.peaks import FLOPS_PER_S


def read(ctx):
    prec = ctx["config"]["precision"]
    node, edge = FLOPS_PER_S[prec["node_products"]], FLOPS_PER_S[prec["edge_products"]]
    least = sum(c["flops"]["node"] / node + c["flops"]["edge"] / edge
                for c in ctx["window"]["counts"])
    seconds = ctx["window"]["seconds"]
    return 100.0 * least / seconds if least > 0 and seconds > 0 else None
