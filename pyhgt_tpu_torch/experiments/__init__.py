"""Experiment assembly, runners and serving (counterpart of
:mod:`pyhgt_tpu.experiments`; the ogbn-mag runner is ported, the OAG
runners are not yet)."""

from pyhgt_tpu_torch.experiments.engine import run_ogbn

__all__ = ["run_ogbn"]
