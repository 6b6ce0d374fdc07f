"""Deterministic seeding (reference: src/utils/seed.py:6-11).

Counterpart of explicit_alignment_for_vqa_tasks_tpu/utils/seed.py: the
host-side libraries (python ``random``, numpy) and torch's global
generators are seeded, and the run's root generator is a
``torch.Generator`` where the JAX package returns a ``jax.random`` key.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed the host RNGs and torch (every device) and return a CPU
    ``torch.Generator`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
    torch.manual_seed(seed)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen
