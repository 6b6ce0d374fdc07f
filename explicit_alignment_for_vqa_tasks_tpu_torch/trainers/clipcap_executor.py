"""ClipCap executor: GPT-2 and a mapper trained and evaluated on VQA2
(``configs/vqa2/clip_cap.jsonnet``'s ``train.type``).

Counterpart of explicit_alignment_for_vqa_tasks_tpu/trainers/
clipcap_executor.py (reference: src/trainers/clipcap_exector.py:42-395):
pad = eos; the tied token table grown with the JAX package's numpy draws
when the tokenizer holds more tokens than the LM; training labels masking
everything up to and including the first BOS, so the loss covers only the
answer and the first pad as EOS (reference :132-171); ``clipcap_loss`` on
the last CLIP row, its gradient into the mapper alone (through
``fused_gpt2_block_vjp`` where the model's dispatch takes the kernel), one
``MultiStepAdamW`` micro-step a batch; greedy generation from [prefix;
prompt] whose prediction is the decoded text from the BOS on (reference
:245-265), scored as the few-shot eval scores. The model lives on the card
unless the caller passes ``device``; each batch's numpy arrays are moved
onto it. Over several processes it trains data-parallel on the active
mesh, its GPT-2 whole on every rank (JAX ``base_executor.py:139-143``):
each data rank's shard, the loss over the global batch's valid tokens, the
mapper's gradients summed over the data axes.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List

import numpy as np
import torch

from ..device import DeviceLike
from ..models.clipcap import clipcap_loss
from ..parallel.gather import gather_predictions_to_host0
from ..parallel.mesh import data_sum, sum_grads_over_data
from ..registry import EXECUTORS
from ..utils.attr_dict import AttrDict
from .base_executor import BaseExecutor, tree_to_device
from .few_shot_vqa_executor import TABLE_COLUMNS
from .model_factory import build_model_from_config
from .optimization import make_optimizer, tree_leaves

logger = logging.getLogger(__name__)

# the resized rows' draws (JAX clipcap_executor.py:68-70)
RESIZE_SEED, RESIZE_STD = 0, 0.02


def resized_wte(wte: torch.Tensor, needed: int,
                dtype: torch.dtype) -> torch.Tensor:
    """``wte`` (V, D) grown to (needed, D): the new rows drawn from
    ``np.random.default_rng(0).normal(0, 0.02)`` in fp32, the whole table
    cast to ``dtype`` (the JAX package casts to ``wpe``'s)."""
    extra = np.random.default_rng(RESIZE_SEED).normal(
        0, RESIZE_STD, size=(needed - wte.shape[0], wte.shape[1])
    ).astype(np.float32)
    return torch.cat([wte.float(), torch.from_numpy(extra).to(wte.device)]
                     ).to(dtype)


def answer_labels(input_ids: np.ndarray, pad_id: int,
                  bos_id: Any) -> np.ndarray:
    """Labels that cover the answer only (JAX ``_answer_labels``, :98-122):
    every position up to and including the first BOS is -100 (all of a row
    without one); the first pad stays as the EOS target, later pads are
    -100, and pads before the BOS stay masked (left padding)."""
    labels = input_ids.astype(np.int64).copy()
    is_pad = labels == pad_id
    is_bos = labels == bos_id
    has_bos = is_bos.any(axis=1)
    bos_pos = np.where(has_bos, is_bos.argmax(axis=1), labels.shape[1])
    col = np.arange(labels.shape[1])[None, :]
    before_or_at_bos = col <= bos_pos[:, None]
    has_pad = is_pad.any(axis=1)
    first_pad = np.where(has_pad, is_pad.argmax(axis=1), labels.shape[1])
    after_first_pad = is_pad & (col > first_pad[:, None])
    out = labels.copy()
    out[before_or_at_bos] = -100
    out[is_pad] = pad_id
    out[after_first_pad] = -100
    out[before_or_at_bos & is_pad] = -100
    return out


def last_clip_row(clip: Any) -> np.ndarray:
    """The test image's embedding: ``clip[:, -1]`` of (B, P, size)."""
    clip = np.asarray(clip)
    return clip[:, -1] if clip.ndim == 3 else clip


@EXECUTORS.register()
class ClipCapExecutor(BaseExecutor):
    def __init__(self, config: Any, data_loader: Any,
                 device: DeviceLike = None):
        super().__init__(config, data_loader)
        if getattr(self.tokenizer, "pad_token", None) is None:
            self.tokenizer.pad_token = self.tokenizer.eos_token
            self.tokenizer.pad_token_id = self.tokenizer.eos_token_id
        self.model, _ = build_model_from_config(config, device=device)
        self._maybe_resize_embeddings()
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

    def _maybe_resize_embeddings(self) -> None:
        """Grow the tied token table to the tokenizer's length when special
        tokens were added (reference: clipcap_exector.py:55-56
        resize_token_embeddings)."""
        try:
            needed = len(self.tokenizer)
        except TypeError:
            return
        cfg = self.model.cfg
        if needed <= cfg.lm.vocab_size:
            return
        lm = self.model.params["lm"]
        lm["wte"] = resized_wte(lm["wte"], needed, lm["wpe"].dtype)
        self.model.cfg = dataclasses.replace(
            cfg, lm=dataclasses.replace(cfg.lm, vocab_size=needed))
        logger.info("resized token embeddings to %d", needed)

    def _to_model(self, array: Any) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), device=self.model.device)

    def _answer_labels(self, input_ids: np.ndarray) -> np.ndarray:
        return answer_labels(input_ids, self.tokenizer.pad_token_id,
                             self.tokenizer.bos_token_id)

    # ------------------------------------------------------------------
    def training_step(self, batch: AttrDict, batch_idx: int) -> Dict:
        input_ids = np.asarray(batch.input_ids)
        labels = self._answer_labels(input_ids)
        if batch.get("null_step"):  # a short shard's padding step
            labels = np.full_like(labels, -100)
        labels = self._to_model(labels)
        loss = clipcap_loss(
            self.model.params["mapper"], self.model.params["lm"],
            self.model.cfg, self._to_model(last_clip_row(
                batch.clip_embeddings)),
            self._to_model(input_ids), self._to_model(batch.attention_mask),
            labels, token_count=self._global_token_count(labels))
        loss.backward()
        sum_grads_over_data(self.mesh, self.optimizer.params)
        self.optimizer.step()
        return {"loss": data_sum(loss.detach(), self.mesh)}

    def trainable_state(self) -> Dict[str, Any]:
        return {"mapper": self.model.params["mapper"],
                "opt_state": self.optimizer.state_dict()}

    def load_trainable_state(self, state: Dict[str, Any]) -> None:
        """The mapper copied into the trained tensors. The optimizer's
        state is saved but not loaded back, as in the JAX package
        (clipcap_executor.py:146-149)."""
        saved = tree_leaves(tree_to_device(state["mapper"],
                                           self.model.device))
        with torch.no_grad():
            for tensor, value in zip(tree_leaves(self.model.params["mapper"]),
                                     saved):
                tensor.copy_(value)

    # ------------------------------------------------------------------
    def _generative_step(self, batch: AttrDict, batch_idx: int) -> Dict:
        """Greedy generation; prediction = decoded text from the BOS on
        (reference: clipcap_exector.py:213-311)."""
        input_ids = np.asarray(batch.generative_input_ids)
        tokens, _ = self.model.generate(
            self._to_model(last_clip_row(batch.clip_embeddings)),
            self._to_model(input_ids),
            self._to_model(batch.generative_attention_mask),
            max_new_tokens=int(
                self.config.data_loader.additional.max_target_length),
            eos_token_id=self.tokenizer.eos_token_id,
        )
        tokens_np = tokens.cpu().numpy()
        valid = np.asarray(
            batch.get("sample_valid", np.ones(len(tokens_np), dtype=bool)))
        predictions, table_entries = [], []
        lookup = self.data_loader.data.vqa_data.lookup
        for index, question_id in enumerate(batch.question_ids):
            if index >= len(tokens_np) or not valid[index]:
                continue
            decoded = self.decode_prediction(tokens_np[index].tolist())
            predictions.append({"question_id": question_id,
                                "answer": decoded})
            item = lookup[str(question_id)]
            table_entries.append([
                question_id, item["img_key"], item["question"],
                self.tokenizer.decode(input_ids[index].tolist()),
                item["answers"], item["gold_answer"], decoded,
            ])
        return {
            "predictions": predictions,
            "question_ids": list(batch.question_ids),
            "answers": list(batch.answers),
            "table_entries": table_entries,
        }

    def decode_prediction(self, tokens: List[int]) -> str:
        """A generated row's answer: the decoded text from the first BOS
        on (the whole row without one), special tokens skipped."""
        bos_id = self.tokenizer.bos_token_id
        if bos_id is not None and bos_id in tokens:
            tokens = tokens[tokens.index(bos_id):]
        return self.decoder_tokenizer.decode(
            tokens, skip_special_tokens=True).strip()

    def evaluate_outputs(self, step_outputs: List[Dict],
                         mode: str = "test") -> AttrDict:
        predictions: List[Dict] = []
        rows: List[List] = []
        for i, out in enumerate(step_outputs):
            predictions.extend(out["predictions"])
            if i < 10:
                rows.extend(out["table_entries"])
        # over several processes the scorer needs every rank's shard
        predictions = gather_predictions_to_host0(predictions)
        data = AttrDict(mode=mode, epoch=self.current_epoch,
                        batch_predictions=predictions)
        log_dict = self.compute_metrics(data)
        log_dict.artifacts["test_table"] = {
            "columns": TABLE_COLUMNS, "rows": rows,
        }
        return log_dict
