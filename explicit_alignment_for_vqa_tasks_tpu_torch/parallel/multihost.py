"""Multi-process runtime initialisation.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/parallel/multihost.py.
A launcher such as ``torchrun --nproc_per_node N`` starts one process a
rank and tells each its place through the environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``); this module builds the process group from it,
before any device is used. Each rank runs on the card of ``LOCAL_RANK``
modulo the card count, so that ranks can share a card.

The collective backend is chosen in one place, from the topology
(``choose_backend``): NCCL where every rank of the node has a card of its
own, gloo where ranks share a card (NCCL refuses a communicator in which two
ranks hold the same card) or there is none. Under NCCL the group is
``cpu:gloo,cuda:nccl``, so that the exchanges of host data (pickled
predictions, statistics) still go through gloo. Gloo takes CUDA tensors
for ``all_reduce`` and ``broadcast`` only; every other exchange of CUDA
tensors goes through a host copy (``gather.all_gather_host``).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import world_size

logger = logging.getLogger(__name__)

_BACKEND: Optional[str] = None


def choose_backend(cards: Optional[int] = None,
                   local_ranks: Optional[int] = None) -> str:
    """"nccl" where each of this node's ``local_ranks`` ranks has a card of
    its own among ``cards``, else "gloo" (ranks share a card, or there is
    none). By default the cards are ``torch.cuda.device_count()`` (0 where
    CUDA is not available) and the ranks the launcher's
    ``LOCAL_WORLD_SIZE`` (``WORLD_SIZE`` where it is unset)."""
    if cards is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_ranks is None:
        local_ranks = int(os.environ.get(
            "LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if cards > 0 and local_ranks <= cards else "gloo"


def backend() -> Optional[str]:
    """The backend of this process's group: the one ``choose_backend``
    gave, or the backend of a group built elsewhere; None with no group."""
    if _BACKEND is not None:
        return _BACKEND
    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend())
    return None


def maybe_initialize_distributed() -> bool:
    """Build the process group when the launcher started more than one
    process; True when one is up."""
    global _BACKEND
    if world_size() == 1:
        return dist.is_available() and dist.is_initialized()
    if not dist.is_initialized():
        _BACKEND = choose_backend()
        dist.init_process_group(
            "cpu:gloo,cuda:nccl" if _BACKEND == "nccl" else "gloo",
            init_method="env://")
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    logger.info("torch.distributed initialised: rank %d of %d (%s)",
                dist.get_rank(), dist.get_world_size(), _BACKEND or "gloo")
    return True
