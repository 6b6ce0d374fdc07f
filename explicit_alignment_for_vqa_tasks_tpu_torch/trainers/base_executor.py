"""BaseExecutor: the eval run loop (replaces PyTorch-Lightning).

Counterpart of explicit_alignment_for_vqa_tasks_tpu/trainers/base_executor.py,
its eval half: subclasses implement ``_generative_step`` and
``evaluate_outputs``; the base runs the eval loop, logs the metrics
(reference: base_executor.py:59-71) and loads the checkpoint
(reference: src/main.py:35-66). One process on one card: where the JAX
package places params and batches on a device mesh, the port moves them
onto the model's device. Training is not ported yet (ROADMAP.md, Queue 1
item 10): ``train`` raises.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

import torch

from ..utils.attr_dict import AttrDict
from ..utils.loggers import MultiLogger
from .checkpointing import get_checkpoint_model_path, load_checkpoint
from .metrics_processors import MetricsProcessor

logger = logging.getLogger(__name__)


def tree_to_device(tree: Any, device: torch.device) -> Any:
    """Every tensor of a nested dict moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class BaseExecutor(MetricsProcessor):
    def __init__(self, config: Any, data_loader: Any):
        self.config = config
        self.data_loader = data_loader
        self.tokenizer = data_loader.tokenizer
        self.decoder_tokenizer = data_loader.decoder_tokenizer
        self.current_epoch = 0
        self.global_step = 0
        self.in_sanity_check = False
        self.multi_logger: Optional[MultiLogger] = None

    def _maybe_calibrate_int8(self) -> None:
        """Deferred int8 quantization (tpu.int8_calibrate_batches > 0):
        executors that can supply encoder calibration batches override
        this (FewShotVQAExecutor). The base refuses loudly — a model
        left pending would fail later with a missing ffn_q8 error."""
        if getattr(getattr(self, "model", None),
                   "pending_int8_calibration", None):
            raise ValueError(
                "tpu.int8_calibrate_batches is set but "
                f"{type(self).__name__} has no int8 calibration support; "
                "unset it (build-time quantization) or run the eval "
                "through FewShotVQAExecutor"
            )

    # ------------------------------------------------------------------
    def setup(self, multi_logger: Optional[MultiLogger] = None) -> None:
        self.multi_logger = multi_logger

    def log_metrics(self, metrics: Dict[str, float],
                    step: Optional[int] = None) -> None:
        if self.multi_logger is not None:
            self.multi_logger.log_metrics(metrics, step or self.global_step)

    @property
    def test_dataloader(self):
        return self.data_loader.test_dataloader

    # -- subclass hooks --------------------------------------------------
    def _generative_step(self, batch: AttrDict, batch_idx: int) -> Dict:
        raise NotImplementedError

    def evaluate_outputs(self, step_outputs: List[Dict],
                         mode: str = "test") -> AttrDict:
        raise NotImplementedError

    def load_trainable_state(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def train(self) -> None:
        raise NotImplementedError(
            "training is not ported yet (ROADMAP.md, Queue 1 item 10): "
            "run --mode test")

    # ------------------------------------------------------------------
    def _eval_loop(self, max_batches: Optional[int] = None) -> List[Dict]:
        """Each test batch through ``_generative_step``, in order. The
        JAX package overlaps batch N+1's dispatch with batch N's collect;
        here generate waits on the host at every decode step
        (ops/decoding.py), so such an overlap would hide nothing."""
        self._maybe_calibrate_int8()
        outputs: List[Dict] = []
        for batch_idx, batch in enumerate(self.test_dataloader):
            if max_batches is not None and batch_idx >= max_batches:
                break
            outputs.append(self._generative_step(batch, batch_idx))
        return outputs

    def test(self) -> Dict[str, float]:
        num_eval = int(self.config.test.get("num_evaluation", 0) or 0)
        outputs = self._eval_loop(num_eval or None)
        log_dict = self.evaluate_outputs(outputs, mode="test")
        return self.logging_results(
            log_dict,
            prefix=self.config.test.get("evaluation_name", "test_evaluation"),
        )

    # ------------------------------------------------------------------
    def logging_results(self, log_dict: AttrDict,
                        prefix: str = "test") -> Dict[str, float]:
        """Prefix metrics, log scalars, emit prediction tables
        (reference: few_shot_vqa_executor.py:370-413)."""
        metrics_to_log: Dict[str, float] = {}
        for metric, value in log_dict.metrics.items():
            metrics_to_log[f"{prefix}/{metric}"] = value
        metrics_to_log[f"{prefix}/epoch"] = self.current_epoch
        logger.info("evaluation results [%s]: %s", prefix, metrics_to_log)
        if self.in_sanity_check:
            logger.warning("sanity check mode: results not logged")
            return metrics_to_log
        self.log_metrics(metrics_to_log)
        table = log_dict.artifacts.get("test_table")
        if table and self.config.get("args", {}).get("log_prediction_tables"):
            if self.multi_logger is not None:
                self.multi_logger.log_table(
                    f"predictions_epoch{self.current_epoch}"
                    f"_MODE({self.config.mode})",
                    table["columns"], table["rows"],
                )
            # always persist a JSON copy (works without wandb)
            out_dir = self.config.get("results_path") or self.config.get(
                "log_path", "."
            )
            try:
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(
                    out_dir,
                    f"prediction_table_epoch{self.current_epoch}.json",
                )
                with open(path, "w", encoding="utf-8") as fh:
                    json.dump(table, fh, default=str)
                logger.info("wrote prediction table to %s", path)
            except OSError as exc:
                logger.warning("could not write prediction table: %s", exc)
        return metrics_to_log

    # ------------------------------------------------------------------
    def maybe_load_checkpoint(self) -> str:
        """Load the test checkpoint that ``config.test`` names; test mode
        without one raises (reference: base_executor.py:510-537)."""
        path = get_checkpoint_model_path(
            self.config.saved_model_path,
            load_epoch=int(self.config.test.get("load_epoch", -1)),
            load_best_model=bool(self.config.test.get("load_best_model", 0)),
            load_model_path=self.config.test.get("load_model_path", ""),
        )
        if path is None:
            raise FileNotFoundError(
                "test mode requires a checkpoint but none was found "
                f"under {self.config.saved_model_path}"
            )
        state = dict(load_checkpoint(path))
        state.pop("epoch", None)
        self.load_trainable_state(state)
        logger.info("loaded checkpoint %s", path)
        return path
