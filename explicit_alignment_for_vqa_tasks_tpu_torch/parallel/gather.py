"""Exchanges of host data between the processes of an eval.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/parallel/gather.py. The
VQA protocol asserts that the predictions cover EVERY annotated question
(utils/vqa_tools.py), so under multi-process evaluation each data shard's
predictions reach the scorer before scoring; on a mesh with a model axis
the ranks of one model group hold the same predictions, and only its first
rank's are gathered, so that no question counts twice. A single process (no
process group) gets its input back. Gloo gathers no CUDA tensor:
``all_gather_host`` is the exchange of tensors that takes its copy through
the host.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from .mesh import active_mesh

logger = logging.getLogger(__name__)


def _processes() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def gather_predictions_to_host0(predictions: List[Any]) -> List[Any]:
    """Every data shard's predictions, rank 0's first, then rank 1's and so
    on (of each model group its first rank's only), on every rank (rank 0
    scores them; the others may discard them)."""
    count = _processes()
    if count == 1:
        return predictions
    mesh = active_mesh()
    if mesh is not None and mesh.model_rank != 0:
        predictions = []
    parts: List[Any] = [None] * count
    dist.all_gather_object(parts, predictions)
    merged = [p for part in parts for p in part]
    logger.info("gathered %d predictions from %d processes", len(merged),
                count)
    return merged


def metric_psum(value: torch.Tensor) -> torch.Tensor:
    """A scalar metric summed over the data axes of the active mesh, or
    over the processes where there is none (a copy; on the CPU, for the
    gloo group)."""
    total = value.detach().to("cpu", copy=True)
    mesh = active_mesh()
    if mesh is not None:
        if mesh.data_group is not None:
            dist.all_reduce(total, op=dist.ReduceOp.SUM,
                            group=mesh.data_group)
    elif _processes() > 1:
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


def all_gather_host(value: torch.Tensor, group: Optional[Any] = None
                    ) -> List[torch.Tensor]:
    """``value`` of every rank of ``group`` (the world by default), in rank
    order, each on ``value``'s device. The exchange goes through host
    copies, since gloo's ``all_gather`` takes no CUDA tensor; the shapes
    must agree across the ranks."""
    host = value.detach().to("cpu", copy=True).contiguous()
    parts = [torch.empty_like(host)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, host, group=group)
    return [p.to(value.device) for p in parts]
