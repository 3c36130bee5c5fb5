"""Experiment assembly, runners and serving (counterpart of
:mod:`pyhgt_tpu.experiments`: the ogbn-mag, paper-field / paper-venue and
author-disambiguation runners at dp = tp = gp = pp = 1)."""

from pyhgt_tpu_torch.experiments.engine import (
    run_author_disambiguation,
    run_node_classification,
    run_ogbn,
)

__all__ = ["run_author_disambiguation", "run_node_classification",
           "run_ogbn"]
