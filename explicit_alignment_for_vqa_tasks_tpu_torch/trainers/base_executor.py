"""BaseExecutor: the run loop (replaces PyTorch-Lightning).

Counterpart of explicit_alignment_for_vqa_tasks_tpu/trainers/base_executor.py
(reference: src/trainers/base_executor.py:34-84 + the PL Trainer wiring in
src/main.py:85-197): subclasses implement ``training_step`` /
``_generative_step`` / ``evaluate_outputs`` and the ``trainable_state`` /
``load_trainable_state`` hooks; the base provides the epoch loop, periodic
validation (``valid.step_size`` steps, capped at ``valid.break_interval``
batches), checkpointing every ``train.save_interval`` epochs with
best/last aliases, metric logging (reference: base_executor.py:59-71), a
two-batch sanity validation before training, and checkpoint loading
(reference: src/main.py:35-66), a train run resuming at the epoch after
the checkpoint's. The model lives on one card; over several processes
the active mesh (``parallel/mesh.py``, built by ``main``) places the rest
(``_setup_mesh``, as JAX ``base_executor.py:46-199``): the T5 split over the
model axis, the mapper broadcast from the first rank, the batches sharded
by the loaders over the data axes; every data rank takes as many training
steps as the longest shard (``_train_batches``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import rank
from ..parallel.mesh import (
    active_mesh,
    data_max,
    data_sum,
    replicate_params,
    shard_lm_params,
)
from ..utils.attr_dict import AttrDict
from ..utils.loggers import MultiLogger
from ..utils.profiling import ThroughputMeter
from .checkpointing import (
    get_checkpoint_model_path,
    load_checkpoint,
    save_checkpoint,
)
from .metrics_processors import MetricsProcessor

# tpu.profile_dir: torch.profiler traces these training steps (0-based
# global steps [first, last)), once training is warm
PROFILE_STEPS = (10, 13)

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
        self.mesh = None  # the active mesh, set by _setup_mesh

    def _setup_mesh(self, model: Any) -> None:
        """Join the active mesh, where there is one: the mapper broadcast
        from the mesh's first rank (every rank then holds the same value,
        JAX's invariant), and a T5 LM split over the model axis
        (``shard_lm_params``) unless its deferred int8 calibration is
        pending (``_reshard_lm`` splits it after).
        Another LM (ClipCap's GPT-2) stays whole on every rank: it trains
        data-parallel only (JAX ``base_executor.py:139-143``)."""
        self.mesh = active_mesh()
        if self.mesh is None:
            return
        replicate_params(self.mesh, model.params["mapper"])
        is_t5 = "shared" in model.params["lm"]
        if is_t5 and not getattr(model, "pending_int8_calibration", None):
            self._reshard_lm(model)
        logger.info("mesh active: %s", dict(self.mesh.shape))

    def _reshard_lm(self, model: Any = None) -> None:
        """The whole T5 tree split over the model axis (after the deferred
        int8 quantization, which reads the whole weights); nothing with no
        model axis."""
        model = model if model is not None else self.model
        if self.mesh is not None and self.mesh.model_size > 1:
            model.params["lm"] = shard_lm_params(self.mesh,
                                                 model.params["lm"])

    def _replicate_loaded(self, params: Any) -> Any:
        """Checkpoint-loaded params broadcast from the mesh's first rank (the
        identity without a mesh)."""
        return replicate_params(self.mesh, params)

    def _global_token_count(self, labels: Any) -> Optional[Any]:
        """The valid (not -100) labels of the global batch, summed over the
        data axes; None with one data way, where a loss divides by its own
        batch's count."""
        if self.mesh is None or self.mesh.data_group is None:
            return None
        return data_sum((labels != -100).sum().float(), self.mesh)

    def _train_batches(self):
        """The epoch's training batches. With more than one data way every
        data rank takes as many steps as the longest shard (else the
        gradients' all-reduce would wait forever): a short rank's missing
        steps are its last batch marked ``null_step``, whose labels the
        executors set to -100, so that it adds nothing to the loss's
        numerator or to its token count."""
        loader = self.train_dataloader
        if self.mesh is None or self.mesh.data_group is None:
            yield from loader
            return
        steps = len(loader)
        most = data_max(steps, self.mesh)
        last = None
        for batch in loader:
            last = batch
            yield batch
        if most > steps and last is None:
            raise ValueError(
                "a data rank's training shard holds no batch: use fewer "
                "data ways or more rows")
        for _ in range(most - steps):
            null = AttrDict(last)
            null["null_step"] = True
            yield null

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
    def train_dataloader(self):
        return self.data_loader.train_dataloader

    @property
    def test_dataloader(self):
        return self.data_loader.test_dataloader

    # -- subclass hooks --------------------------------------------------
    def training_step(self, batch: AttrDict, batch_idx: int):
        raise NotImplementedError

    def _generative_step(self, batch: AttrDict, batch_idx: int) -> Dict:
        raise NotImplementedError

    def evaluate_outputs(self, step_outputs: List[Dict],
                         mode: str = "test") -> AttrDict:
        raise NotImplementedError

    def on_train_start(self) -> None:
        pass

    def trainable_state(self) -> Dict[str, Any]:
        """State persisted in checkpoints (the mapper, the optimizer's)."""
        raise NotImplementedError

    def load_trainable_state(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------------
    def train(self) -> None:
        """The epoch loop (JAX base_executor.py:322-415)."""
        cfg = self.config
        max_epochs = int(cfg.train.get("epochs", 1))
        step_size = int(cfg.valid.get("step_size", 0) or 0)
        save_interval = int(cfg.train.get("save_interval", 1))
        self.on_train_start()

        # sanity-check validation (PL behavior: 2 batches)
        self.in_sanity_check = True
        try:
            self.validate(max_batches=2)
        finally:
            self.in_sanity_check = False

        meter = ThroughputMeter(device=getattr(getattr(self, "model", None),
                                               "device", None))
        profile_dir = cfg.get("tpu", {}).get("profile_dir", "")
        profiler = None

        for epoch in range(self.current_epoch, max_epochs):
            self.current_epoch = epoch
            if hasattr(self.train_dataloader, "set_epoch"):
                self.train_dataloader.set_epoch(epoch)
            epoch_t0 = time.perf_counter()
            losses: List[float] = []
            for batch_idx, batch in enumerate(self._train_batches()):
                if profile_dir and self.global_step == PROFILE_STEPS[0]:
                    profiler = _start_profiler()
                meter.start()
                out = self.training_step(batch, batch_idx)
                meter.stop(items=int(cfg.train.batch_size))
                self.global_step += 1
                if profiler is not None and \
                        self.global_step == PROFILE_STEPS[1]:
                    _stop_profiler(profiler, profile_dir)
                    profiler = None
                if out is not None and "loss" in out:
                    loss = float(out["loss"])
                    losses.append(loss)
                    if self.global_step % 50 == 0:
                        self.log_metrics({"train/loss": loss})
                if step_size and self.global_step % step_size == 0:
                    self.validate(
                        max_batches=int(
                            cfg.valid.get("break_interval", 0) or 0
                        ) or None
                    )
            epoch_time = time.perf_counter() - epoch_t0
            if losses:
                summary = meter.summary()
                self.log_metrics({
                    "train/loss_epoch": float(np.mean(losses)),
                    "train/epoch_time_s": epoch_time,
                    "train/examples_per_s": summary.get("items_per_s", 0.0),
                    "train/mean_step_s": summary.get("mean_step_s", 0.0),
                })
            logger.info(
                "epoch %d done in %.1fs (mean loss %s)",
                epoch, epoch_time,
                f"{np.mean(losses):.4f}" if losses else "n/a",
            )

            val_metrics = self.validate()
            if (epoch + 1) % save_interval == 0:
                metric_name = cfg.train.additional.get(
                    "save_top_k_metric", "valid/loss")
                metric_mode = cfg.train.additional.get(
                    "save_top_k_mode", "min")
                save_checkpoint(
                    cfg.saved_model_path, epoch, self.trainable_state(),
                    metric_value=val_metrics.get(metric_name),
                    metric_mode=metric_mode,
                )
            if self.multi_logger is not None:
                self.multi_logger.log_auto_extrema(self.global_step)
        if profiler is not None:  # the run ended inside the window
            _stop_profiler(profiler, profile_dir)

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

    def validate(self, max_batches: Optional[int] = None
                 ) -> Dict[str, float]:
        outputs = self._eval_loop(max_batches)
        if not outputs:
            return {}
        log_dict = self.evaluate_outputs(outputs, mode="test")
        return self.logging_results(log_dict, prefix="valid")

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
        if table and self.config.get("args", {}).get(
                "log_prediction_tables") and rank() == 0:
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
    def maybe_load_checkpoint(self) -> Optional[str]:
        """Load the checkpoint that ``config.test`` (test mode) or
        ``config.train`` names: test mode without one raises, a train run
        without one starts afresh, and a train run from one resumes at the
        epoch after it (reference: base_executor.py:510-537)."""
        block = self.config.test if self.config.mode == "test" \
            else self.config.train
        path = get_checkpoint_model_path(
            self.config.saved_model_path,
            load_epoch=int(block.get("load_epoch", -1)),
            load_best_model=bool(block.get("load_best_model", 0)),
            load_model_path=block.get("load_model_path", ""),
        )
        if path is None:
            if self.config.mode == "test":
                raise FileNotFoundError(
                    "test mode requires a checkpoint but none was found "
                    f"under {self.config.saved_model_path}"
                )
            logger.info("no checkpoint found — first time to train")
            return None
        state = dict(load_checkpoint(path))
        epoch = state.pop("epoch", None)
        self.load_trainable_state(state)
        if self.mesh is not None:
            self._replicate_loaded(self.model.params["mapper"])
        if self.config.mode == "train" and epoch is not None:
            self.current_epoch = int(epoch) + 1
            logger.info("resuming from epoch %d", self.current_epoch)
        logger.info("loaded checkpoint %s", path)
        return path


def _start_profiler() -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler: torch.profiler.profile, profile_dir: str) -> None:
    """End the trace and write it under ``profile_dir`` as a Chrome trace
    (the JAX package writes its ``jax.profiler`` trace there)."""
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "train_steps.trace.json")
    profiler.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
