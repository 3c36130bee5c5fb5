"""Train step: the share of the float32 and bf16 peaks that a DenseHGT
cell's window reaches, ``train_mfu``'s sum with the position-wise FFN
added, which ``benchmark.flops`` does not count: per layer and valid node
(``counts["nodes"]``, every type) ``mid`` (D to 2D) and ``out`` (2D to D),
8 D^2 FLOPs forward and 24 D^2 forward and backward. The FFN is a node
product, taken at the node products' peak; the least time of the window's
FLOPs over the window's seconds, in percent."""

from benchmark.peaks import FLOPS_PER_S


def ffn_flops(n_nodes: int, n_hid: int, n_layers: int) -> float:
    """The FFN's FLOPs in one forward and backward over ``n_nodes``."""
    return 24.0 * n_layers * n_nodes * n_hid * n_hid


def node_flops(count: dict, config: dict) -> float:
    """A step's node-level FLOPs, the FFN's included."""
    return count["flops"]["node"] + ffn_flops(
        sum(count["nodes"].values()), config["n_hid"], config["n_layers"])


def read(ctx):
    cfg = ctx["config"]
    prec = cfg["precision"]
    node, edge = FLOPS_PER_S[prec["node_products"]], FLOPS_PER_S[prec["edge_products"]]
    least = sum(node_flops(c, cfg) / node + c["flops"]["edge"] / edge
                for c in ctx["window"]["counts"])
    seconds = ctx["window"]["seconds"]
    return 100.0 * least / seconds if least > 0 and seconds > 0 else None
