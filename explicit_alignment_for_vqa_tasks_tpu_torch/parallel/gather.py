"""Exchanges of host data between the processes of an eval.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/parallel/gather.py. The
VQA protocol asserts that the predictions cover EVERY annotated question
(utils/vqa_tools.py), so under multi-process evaluation each rank's
predictions reach the scorer before scoring. A single process (no process
group) gets its input back.
"""

from __future__ import annotations

import logging
from typing import Any, List

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def _processes() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def gather_predictions_to_host0(predictions: List[Any]) -> List[Any]:
    """Every rank's predictions, rank 0's first, then rank 1's and so on,
    on every rank (rank 0 scores them; the others may discard them)."""
    count = _processes()
    if count == 1:
        return predictions
    parts: List[Any] = [None] * count
    dist.all_gather_object(parts, predictions)
    merged = [p for part in parts for p in part]
    logger.info("gathered %d predictions from %d processes", len(merged),
                count)
    return merged


def metric_psum(value: torch.Tensor) -> torch.Tensor:
    """A scalar metric summed over the processes (a copy; on the CPU, for
    the gloo group)."""
    total = value.detach().to("cpu", copy=True)
    if _processes() > 1:
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total


def max_across_processes(value: torch.Tensor) -> torch.Tensor:
    """The element-wise maximum of ``value`` over the processes, on
    ``value``'s device; ``value`` itself where there is one process."""
    if _processes() == 1:
        return value
    host = value.detach().to("cpu", copy=True)
    dist.all_reduce(host, op=dist.ReduceOp.MAX)
    return host.to(value.device)
