"""Experiment assembly, runners and serving (counterpart of
:mod:`pyhgt_tpu.experiments`: the ogbn-mag, paper-field / paper-venue and
author-disambiguation runners, on one device or under the dp, gp and pp
parallel modes)."""

from pyhgt_tpu_torch.experiments.engine import (
    run_author_disambiguation,
    run_node_classification,
    run_ogbn,
)

__all__ = ["run_author_disambiguation", "run_node_classification",
           "run_ogbn"]
