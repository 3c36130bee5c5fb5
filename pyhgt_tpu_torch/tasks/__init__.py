"""Task heads' host side (counterpart of :mod:`pyhgt_tpu.tasks`): the
ogbn-mag task, the OAG node-classification (paper-field / paper-venue) and
author-disambiguation link-prediction tasks, the matcher index, and the
sampling-based evaluation."""

from pyhgt_tpu_torch.tasks.base import (
    TaskBatch,
    TimeSplit,
    build_time_split_pairs,
    subsample_pairs,
)
from pyhgt_tpu_torch.tasks.evaluate import multi_sample_eval
from pyhgt_tpu_torch.tasks.link_prediction import (
    LinkPredictionTask,
    LinkTaskBatch,
)
from pyhgt_tpu_torch.tasks.matcher_index import MatcherIndex
from pyhgt_tpu_torch.tasks.node_classification import NodeClassificationTask
from pyhgt_tpu_torch.tasks.ogbn import OgbnNodeTask

__all__ = [
    "multi_sample_eval",
    "TimeSplit",
    "TaskBatch",
    "build_time_split_pairs",
    "subsample_pairs",
    "NodeClassificationTask",
    "LinkPredictionTask",
    "LinkTaskBatch",
    "MatcherIndex",
    "OgbnNodeTask",
]
