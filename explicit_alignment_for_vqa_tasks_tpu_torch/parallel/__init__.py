"""Multi-process runs over ``torch.distributed``: the process group and the
exchanges of host data between the processes of an eval."""

from .gather import (
    gather_predictions_to_host0,
    max_across_processes,
    metric_psum,
)
from .multihost import maybe_initialize_distributed

__all__ = [
    "gather_predictions_to_host0",
    "max_across_processes",
    "maybe_initialize_distributed",
    "metric_psum",
]
