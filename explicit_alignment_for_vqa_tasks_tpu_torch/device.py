"""Where the port runs: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

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
