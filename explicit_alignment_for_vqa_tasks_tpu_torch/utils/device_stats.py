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


CEILING_SIZE = 8192     # M = N = K of the yardstick products
CEILING_CALLS = 10      # products a timed window
CEILING_TRIALS = 5      # windows; the best counts


def matmul_rates(dev: torch.device) -> dict:
    """The card's own yardsticks, measured in this process: the best rate
    of a bf16 ``torch.matmul`` at CEILING_SIZE cubed (TFLOP/s, the ceiling
    the studies divide by) and of ``torch._int_mm`` on int8 operands of the
    same size (TOP/s), on CUDA events, with their ratio. None where no
    card runs: a host's matmul rate is not a device figure."""
    if dev.type != "cuda":
        return {"measured_ceiling_tflops": None, "int8_tops": None,
                "int8_over_bf16_rate": None}
    n = CEILING_SIZE
    gen = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.randn(n, n, generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    # the second int8 operand column-major, as cuBLASLt's int8 GEMM takes it
    a8, b8 = (torch.randint(-127, 128, (n, n), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    b8 = b8.t()

    def best_s(fn) -> float:
        fn()
        torch.cuda.synchronize(dev)
        best = float("inf")
        for _ in range(CEILING_TRIALS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CEILING_CALLS):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / CEILING_CALLS)
        return best

    ops = 2.0 * n ** 3
    bf16 = ops / best_s(lambda: torch.matmul(a, b)) / 1e12
    int8 = ops / best_s(lambda: torch._int_mm(a8, b8)) / 1e12
    return {"measured_ceiling_tflops": bf16, "int8_tops": int8,
            "int8_over_bf16_rate": int8 / bf16}


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
