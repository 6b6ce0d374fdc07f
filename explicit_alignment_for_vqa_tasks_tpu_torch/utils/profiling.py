"""Step-time and throughput counters of the train loop.

The port's copy of ``ThroughputMeter`` from
explicit_alignment_for_vqa_tasks_tpu/utils/profiling.py (its ``trace``
helper, a ``jax.profiler`` trace, becomes ``torch.profiler`` in
``BaseExecutor.train``). CUDA launches return before the card finishes, so
on a CUDA device ``stop()`` first waits for the current stream: a step's
time is then the card's, not the host's enqueue rate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


@dataclass
class ThroughputMeter:
    """Tracks items/s and step latency, the first ``warmup_steps`` left out
    of the summary (all of them when there are no more)."""

    warmup_steps: int = 2
    device: Optional[torch.device] = None
    _times: List[float] = field(default_factory=list)
    _items: List[int] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, items: int = 1) -> float:
        if self._t0 is None:
            raise RuntimeError("ThroughputMeter.stop: call start() first")
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        self._items.append(items)
        self._t0 = None
        return dt

    def summary(self) -> Dict[str, float]:
        times = self._times[self.warmup_steps:] or self._times
        items = self._items[self.warmup_steps:] or self._items
        if not times:
            return {}
        total_t = sum(times)
        total_i = sum(items)
        return {
            "steps": float(len(times)),
            "mean_step_s": total_t / len(times),
            "min_step_s": min(times),
            "items_per_s": total_i / total_t if total_t > 0 else 0.0,
        }
