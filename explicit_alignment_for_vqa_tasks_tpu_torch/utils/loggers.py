"""Experiment loggers: TensorBoard + optional Weights & Biases + history.

The reference runs three PL loggers side by side (reference:
src/main.py:85-111): TensorBoardLogger, WandbLogger, and a custom in-memory
history logger. We reproduce that trio without PyTorch-Lightning:
`MultiLogger` fans every scalar out to tensorboardX (if available), wandb
(if installed and enabled in config), and a `MetricsHistory`.

The port's own copy of
explicit_alignment_for_vqa_tasks_tpu/utils/loggers.py, held against it by
tests/test_torch_config.py.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional

from .metrics_history import MetricsHistory

logger = logging.getLogger(__name__)


class TensorBoardSink:
    def __init__(self, log_dir: str):
        from tensorboardX import SummaryWriter  # baked into the image

        os.makedirs(log_dir, exist_ok=True)
        self._writer = SummaryWriter(log_dir)

    def log_scalars(self, metrics: Dict[str, float], step: int) -> None:
        for name, value in metrics.items():
            try:
                self._writer.add_scalar(name, float(value), step)
            except (TypeError, ValueError):
                continue

    def close(self) -> None:
        self._writer.close()


def lookup_wandb_run_id(wandb_mod: Any, entity: str, project: str,
                        experiment_name: str) -> Optional[str]:
    """Find an existing wandb run for this experiment name so the new
    process resumes it with ``resume="must"`` (reference:
    src/main.py:313-328). Returns None when no run exists or the API is
    unreachable (zero-egress / offline runs fall back to
    ``resume="allow"``). The reference's interactive run DELETION on
    ``--reset`` (main.py:317-321) is deliberately not reproduced — this
    framework is non-interactive; reset experiments keep their wandb
    history and simply start a fresh run name-collision-free via
    resume="allow"."""
    try:
        runs = wandb_mod.Api(timeout=19).runs(
            path=f"{entity}/{project}",
            filters={"config.experiment_name": experiment_name},
        )
        if len(runs) > 0:
            return runs[0].id
    except Exception as exc:
        logger.info("wandb run lookup skipped (%s); resume='allow'", exc)
    return None


class WandbSink:
    """wandb sink; silently disabled when wandb is not installed.

    Resume parity with the reference (src/main.py:313-328): when the
    configured entity/project already holds a run with this experiment
    name, init resumes THAT run id with ``resume="must"``; otherwise a
    fresh run starts with ``resume="allow"``."""

    def __init__(self, config: Any):
        self._run = None
        try:
            import wandb  # optional
        except ImportError:
            logger.info("wandb not installed; skipping wandb logging")
            return
        wb_cfg = config.get("WANDB", {})
        cache_dir = wb_cfg.get("CACHE_DIR", "")
        if cache_dir:  # reference: src/main.py:303-305
            os.environ["WANDB_CACHE_DIR"] = str(cache_dir)
        entity = wb_cfg.get("entity") or None
        project = wb_cfg.get("project") or "explicit-alignment-tpu"
        name = config.get("experiment_name", "default")
        run_id = None
        if entity:
            run_id = lookup_wandb_run_id(wandb, entity, project, name)
        self._run = wandb.init(
            project=project,
            entity=entity,
            name=name,
            id=run_id,
            tags=list(wb_cfg.get("tags", [])),
            config=config.to_dict() if hasattr(config, "to_dict") else dict(config),
            resume="must" if run_id else "allow",
        )

    def log_scalars(self, metrics: Dict[str, float], step: int) -> None:
        if self._run is not None:
            self._run.log(dict(metrics), step=step)

    def log_table(self, name: str, columns: List[str], rows: List[List]) -> None:
        if self._run is None:
            return
        import wandb

        self._run.log({name: wandb.Table(columns=columns, data=rows)})

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()


class MultiLogger:
    """Fans metrics out to TB + wandb + in-memory history."""

    def __init__(self, config: Any, use_wandb: bool = True, use_tb: bool = True):
        self.history = MetricsHistory()
        self._sinks: List[Any] = []
        if use_tb:
            try:
                self._sinks.append(
                    TensorBoardSink(config.get("tensorboard_path", "tb_logs"))
                )
            except Exception as exc:
                logger.warning("tensorboard logging disabled: %s", exc)
        self._wandb: Optional[WandbSink] = None
        if use_wandb:
            self._wandb = WandbSink(config)
            self._sinks.append(self._wandb)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        scalars = {}
        for name, value in metrics.items():
            try:
                scalars[name] = float(value)
            except (TypeError, ValueError):
                continue
        self.history.log_dict(scalars, step)
        for sink in self._sinks:
            sink.log_scalars(scalars, step)

    def log_table(self, name: str, columns: List[str], rows: List[List]) -> None:
        if self._wandb is not None:
            self._wandb.log_table(name, columns, rows)

    def log_auto_extrema(self, step: int) -> Dict[str, float]:
        """Log running max/min of every tracked metric
        (reference behavior: src/trainers/base_executor.py:59-71)."""
        extrema = self.history.auto_extrema()
        for sink in self._sinks:
            sink.log_scalars(extrema, step)
        return extrema

    def close(self) -> None:
        for sink in self._sinks:
            try:
                sink.close()
            except Exception:
                pass
