"""Device and environment diagnostics.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/utils/device_stats.py
(reference: src/utils/cuda_stats.py:7-22, src/utils/collect_env.py:12-14),
for the CUDA card: PyTorch and CUDA versions, the device count, the card's
name and its power limit (``nvidia-smi``; a card set below its maximum runs
slower under load, so every number the tools print carries it).
"""

from __future__ import annotations

import logging
import platform
import subprocess
import sys
from typing import Dict

import torch

logger = logging.getLogger(__name__)


def device_info(dev: torch.device) -> dict:
    """The card's name and power limit (nvidia-smi) beside every number."""
    if dev.type != "cuda":
        return {"name": str(dev), "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return {"name": torch.cuda.get_device_name(dev),
            "power_limit": smi.split(",")[-1].strip()}


def collect_env_info() -> Dict[str, str]:
    info = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "cuda_available": str(torch.cuda.is_available()),
        "device_count": str(torch.cuda.device_count()
                            if torch.cuda.is_available() else 0),
    }
    if torch.cuda.is_available():
        card = device_info(torch.device("cuda", 0))
        info["device_kind"] = card["name"]
        info["power_limit"] = card["power_limit"]
    for mod in ("numpy", "transformers"):
        module = sys.modules.get(mod)
        if module is not None:
            info[mod] = module.__version__
    return info


def print_device_statistics() -> None:
    """Log the environment and each card's memory (the reference's
    print_cuda_statistics)."""
    for key, value in collect_env_info().items():
        logger.info("%s: %s", key, value)
    if not torch.cuda.is_available():
        return
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        logger.info("cuda:%d memory: %.2f / %.2f GiB in use", i,
                    (total - free) / 2**30, total / 2**30)
