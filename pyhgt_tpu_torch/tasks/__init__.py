"""Task heads' host side (counterpart of :mod:`pyhgt_tpu.tasks`; the OAG
node-classification and link-prediction tasks are not ported yet)."""

from pyhgt_tpu_torch.tasks.base import TaskBatch, TimeSplit
from pyhgt_tpu_torch.tasks.evaluate import multi_sample_eval
from pyhgt_tpu_torch.tasks.ogbn import OgbnNodeTask

__all__ = [
    "multi_sample_eval",
    "TimeSplit",
    "TaskBatch",
    "OgbnNodeTask",
]
