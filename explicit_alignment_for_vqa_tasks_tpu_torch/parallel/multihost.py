"""Multi-process runtime initialisation.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/parallel/multihost.py.
A launcher such as ``torchrun --nproc_per_node N`` starts one process a
rank and tells each its place through the environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``); this module
builds the process group from it, before any device is used. The eval
exchanges host data only (pickled predictions, the int8 calibration
statistics), so the group is ``gloo`` and no tensor of the model goes
through it. Each rank runs on the card of ``LOCAL_RANK`` modulo the card
count, so that ranks can share a card.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from ..device import world_size

logger = logging.getLogger(__name__)


def maybe_initialize_distributed(mode: str) -> bool:
    """Build the process group when the launcher started more than one
    process; True when one is up. ``device.world_size(mode)`` refuses first
    what does not run over processes (every mode but ``test``)."""
    if world_size(mode) == 1:
        return dist.is_available() and dist.is_initialized()
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method="env://")
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    logger.info("torch.distributed initialised: rank %d of %d (gloo)",
                dist.get_rank(), dist.get_world_size())
    return True
