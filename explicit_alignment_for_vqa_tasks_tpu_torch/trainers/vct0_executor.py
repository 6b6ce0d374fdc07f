"""VC-T0 mapping-network training on Conceptual Captions.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/trainers/vct0_executor.py
(reference: src/trainers/vct0_exector.py:40-354): the captioning loss
``vct0_caption_loss`` on the frozen LM, its backward into the mapper and
one ``MultiStepAdamW`` micro-step a batch; validation takes the loss of
every batch and generates captions (prefix-only ``generate``) for the first
6 (reference :185-218). The model lives on the card unless the caller
passes ``device``; each batch's numpy arrays are moved onto it.

Over several processes the loop runs on the active mesh
(``BaseExecutor._setup_mesh``): each data rank takes its shard's batches,
the loss is the global batch's token-weighted cross-entropy (the rank's
numerator over the valid tokens summed over the data axes), the mapper's
gradients are summed over the data axes before each optimizer step, so
that the mapper and its optimizer state stay the same on every rank; a
short shard's missing steps are batches of -100 labels (JAX's
``_pad_for_pipeline`` pads rows so). Under a model axis the T5 is split
and its blocks end in all-reduces (models/t5.py). A pipelined mesh
(``tpu.mesh.pipe`` > 1 over several processes) raises naming ROADMAP.md,
Queue 1 item 14 (the pipeline).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

import numpy as np
import torch

from ..device import DeviceLike
from ..models.vct0 import vct0_caption_loss
from ..parallel.gather import metric_psum
from ..parallel.mesh import data_sum, refuse_pipeline, sum_grads_over_data
from ..registry import EXECUTORS
from ..utils.attr_dict import AttrDict
from .base_executor import BaseExecutor, tree_to_device
from .model_factory import build_model_from_config
from .optimization import make_optimizer, tree_leaves

logger = logging.getLogger(__name__)

CAPTION_TABLE_COLUMNS = ["image_url", "gold_caption", "predicted_caption"]
NUM_CAPTION_GEN_BATCHES = 6


@EXECUTORS.register()
class VCT0Executor(BaseExecutor):
    def __init__(self, config: Any, data_loader: Any,
                 device: DeviceLike = None):
        super().__init__(config, data_loader)
        refuse_pipeline(config)
        self.model, _ = build_model_from_config(config, device=device)
        self._setup_mesh(self.model)
        steps_per_epoch = max(len(data_loader.train_dataloader or []), 1) \
            if data_loader.train_dataloader is not None else 1000
        total_steps = steps_per_epoch * min(
            int(config.train.get("epochs", 1)), 1000)
        mapper = tree_leaves(self.model.params["mapper"])
        for tensor in mapper:
            tensor.requires_grad_(True)
        self.optimizer, self.schedule = make_optimizer(config, total_steps,
                                                       mapper)

    def _to_model(self, array: Any) -> torch.Tensor:
        return torch.as_tensor(array, device=self.model.device)

    @staticmethod
    def _labels(batch: AttrDict) -> np.ndarray:
        """The batch's labels; every one -100 in a null step."""
        labels = np.asarray(batch.labels)
        return np.full_like(labels, -100) if batch.get("null_step") \
            else labels

    def _loss(self, batch: AttrDict, token_count=None) -> torch.Tensor:
        return vct0_caption_loss(
            self.model.params["mapper"], self.model.params["lm"],
            self.model.cfg, self._to_model(batch.clip_embeddings),
            self._to_model(self._labels(batch)), token_count=token_count)

    # ------------------------------------------------------------------
    def training_step(self, batch: AttrDict, batch_idx: int) -> Dict:
        count = self._global_token_count(self._to_model(self._labels(batch)))
        loss = self._loss(batch, token_count=count)
        loss.backward()
        sum_grads_over_data(self.mesh, self.optimizer.params)
        self.optimizer.step()
        if self.global_step % 50 == 0:
            self.log_metrics({"train/lr": float(
                self.schedule(self.global_step))})
        return {"loss": data_sum(loss.detach(), self.mesh)}

    def trainable_state(self) -> Dict[str, Any]:
        return {"mapper": self.model.params["mapper"],
                "opt_state": self.optimizer.state_dict()}

    def load_trainable_state(self, state: Dict[str, Any]) -> None:
        """The mapper copied into the trained tensors (the optimizer holds
        them), and the optimizer's state where the checkpoint has it."""
        saved = tree_leaves(tree_to_device(state["mapper"],
                                           self.model.device))
        with torch.no_grad():
            for tensor, value in zip(tree_leaves(self.model.params["mapper"]),
                                     saved):
                tensor.copy_(value)
        if state.get("opt_state") is not None:
            self.optimizer.load_state_dict(state["opt_state"])

    # ------------------------------------------------------------------
    def _generative_step(self, batch: AttrDict, batch_idx: int) -> Dict:
        with torch.no_grad():
            loss = float(self._loss(batch))
        out: Dict[str, Any] = {"loss": loss, "table_entries": []}
        if batch_idx < NUM_CAPTION_GEN_BATCHES:
            clip = self._to_model(batch.clip_embeddings)
            tokens, _ = self.model.generate(
                prefix=clip[:, None, :],
                max_new_tokens=int(
                    self.config.data_loader.additional.max_target_length),
            )
            captions = [
                self.decoder_tokenizer.decode(t.tolist(),
                                              skip_special_tokens=True)
                for t in tokens.cpu().numpy()
            ]
            out["table_entries"] = [
                [url, gold, pred]
                for url, gold, pred in zip(batch.image_urls, batch.captions,
                                           captions)
            ]
        return out

    def evaluate_outputs(self, step_outputs: List[Dict],
                         mode: str = "test") -> AttrDict:
        losses = [o["loss"] for o in step_outputs if "loss" in o]
        rows: List[List] = []
        for out in step_outputs:
            rows.extend(out.get("table_entries", []))
        log_dict = AttrDict(metrics={}, artifacts={})
        if self.mesh is not None:
            # the data ranks' batches together (each model group's ranks
            # hold the same losses)
            total = metric_psum(torch.tensor(float(np.sum(losses))))
            count = metric_psum(torch.tensor(float(len(losses))))
            if count.item():
                log_dict.metrics["loss"] = float(total / count)
        elif losses:
            log_dict.metrics["loss"] = float(np.mean(losses))
        log_dict.artifacts["test_table"] = {
            "columns": CAPTION_TABLE_COLUMNS, "rows": rows,
        }
        return log_dict
