"""The model FLOPs of one HGT training step, counted from the layer's
equations at a batch's valid nodes and edges (a multiply-add is 2 FLOPs;
additions, activations, the softmax and the norms are not products and
are not counted).

With ``(x + rte) @ W = x @ W + rte @ W`` the equations' products are:

- node products: the input adaptation (``N_t x Din x D`` per type), per
  layer the Q, K, V and A projections (``N_t x D x D`` each), the key and
  value relation transforms of each meta-relation's source nodes
  (``N_src x D x dk`` each), the RTE vector (``240 x D x D``), its key and
  value projections per source type (``240 x D x D`` each) and their
  relation transforms per meta-relation (``240 x D x dk`` each), and the
  head (``rows x D x classes``);
- edge products: per valid edge and layer the score ``<q, k>`` and the
  weighted message (``D`` multiply-adds each).

The backward takes twice the forward's products but for the input
gradient of the first product (the features need none); a recompute is
not counted.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

RTE_LEN = 240


def train_step_flops(n_nodes: Dict[str, int],
                     blocks: Sequence[Tuple[str, str, int]],
                     d_in: int, n_hid: int, n_heads: int, n_layers: int,
                     head_rows: int, n_classes: int) -> Dict[str, float]:
    """``{"node": FLOPs, "edge": FLOPs}`` of one forward and backward.
    ``blocks``: ``(target type, source type, valid edges)`` per
    meta-relation and per type's self loops."""
    D, dk = n_hid, n_hid // n_heads
    adapt = sum(2.0 * n * d_in * D for n in n_nodes.values())
    per_layer = 0.0
    per_layer += 4 * sum(2.0 * n * D * D for n in n_nodes.values())
    src_types = {s for _, s, _ in blocks}
    per_layer += 2.0 * RTE_LEN * D * D
    per_layer += 2 * len(src_types) * 2.0 * RTE_LEN * D * D
    for _, s, _ in blocks:
        per_layer += 2 * 2.0 * (n_nodes[s] + RTE_LEN) * D * dk
    edges = sum(e for _, _, e in blocks)
    node_fwd = adapt + n_layers * per_layer + 2.0 * head_rows * D * n_classes
    edge_fwd = n_layers * 2 * 2.0 * edges * D
    return {"node": 3 * node_fwd - adapt, "edge": 3 * edge_fwd}
