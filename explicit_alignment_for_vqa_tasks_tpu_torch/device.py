"""Where the port runs: the CUDA card unless the caller asks for the CPU,
in one process."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises when no card is present and no device was given: the port never
    moves to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the host"
        )
    return torch.device("cuda")


def make_generator(seed: int, device: Optional[torch.device]) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device``, so random weights are
    drawn where they live."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def world_size() -> int:
    """The processes of this run: ``torch.distributed``'s world when it is
    initialised, else the launcher's ``WORLD_SIZE`` (1 when unset). Raises
    for more than one: each process would evaluate one shard, and the
    gather of predictions to one scorer is not ported yet."""
    if dist.is_available() and dist.is_initialized():
        size = dist.get_world_size()
    else:
        size = int(os.environ.get("WORLD_SIZE", "1"))
    if size > 1:
        raise NotImplementedError(
            f"a {size}-process run is not ported yet (ROADMAP.md, Queue 1 "
            "item 14): run one process")
    return size
