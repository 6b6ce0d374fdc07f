"""In-memory metric history with automatic max/min tracking.

Replaces the reference's MetricsHistoryLogger PL logger
(reference: src/utils/metrics_log_callback.py:7-52) and the auto
``{metric}_auto_max/min`` logging in BaseExecutor
(reference: src/trainers/base_executor.py:59-71).

The port's own copy of
explicit_alignment_for_vqa_tasks_tpu/utils/metrics_history.py, held against it by
tests/test_torch_config.py.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple


class MetricsHistory:
    """Accumulates every logged scalar; answers running max/min queries."""

    def __init__(self) -> None:
        self.history: Dict[str, List[Tuple[int, float]]] = defaultdict(list)

    def log(self, name: str, value: float, step: int) -> None:
        if name in ("epoch", "step"):
            return
        self.history[name].append((step, float(value)))

    def log_dict(self, metrics: Dict[str, float], step: int) -> None:
        for name, value in metrics.items():
            try:
                self.log(name, float(value), step)
            except (TypeError, ValueError):
                continue  # non-scalar payloads (tables etc.) are not tracked

    def values(self, name: str) -> List[float]:
        return [v for _, v in self.history.get(name, [])]

    def auto_extrema(self) -> Dict[str, float]:
        """``{metric}_auto_max`` / ``_auto_min`` over the full history."""
        out: Dict[str, float] = {}
        for name, entries in self.history.items():
            vals = [v for _, v in entries]
            if vals:
                out[f"{name}_auto_max"] = max(vals)
                out[f"{name}_auto_min"] = min(vals)
        return out

    def state_dict(self) -> Dict:
        return {"history": {k: list(v) for k, v in self.history.items()}}

    def load_state_dict(self, state: Dict) -> None:
        self.history = defaultdict(list)
        for key, entries in state.get("history", {}).items():
            self.history[key] = [tuple(e) for e in entries]
