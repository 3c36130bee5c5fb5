"""pyhgt_tpu_torch — the PyTorch + CUDA port of :mod:`pyhgt_tpu`.

The JAX package stays the reference; this package mirrors its module paths
(``pyhgt_tpu_torch/ops/sorted_hgt.py`` <-> ``pyhgt_tpu/ops/sorted_hgt.py``)
and imports nothing of it, nor of JAX. What is ported so far is the HGT
model on the scatter-free sorted-edge path (its forward and its training
step, with the segment sums of both as hand-written Hopper kernels,
:mod:`pyhgt_tpu_torch.ops.pallas_seg`) and on the segment path, every
other conv of the JAX package (DenseHGT, GCN, GAT, RGCN, HAN, HetGNN),
the HGSampling sampler and the host sort, OAG preprocessing and the
reference-pickle converter, and on one device the ogbn-mag, paper-field /
paper-venue and author-disambiguation runners, their evaluation, and node
and link serving (:mod:`pyhgt_tpu_torch.run`), and the parallel modes of
the runners and the bench (:mod:`pyhgt_tpu_torch.parallel`: data
parallelism, edge-partitioned graph parallelism with the kernels on every
shard, GPipe pipelining; one process per rank over ``torch.distributed``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (:func:`resolve_device`).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when asked for. Never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pyhgt_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain CPU path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
