"""Few-shot VQA evaluation executor (the main path).

Counterpart of explicit_alignment_for_vqa_tasks_tpu/trainers/few_shot_vqa_executor.py
(reference: src/trainers/few_shot_vqa_executor.py:46-416): generation
over spliced prompts in every eval mode (main, ``no_prefix``, the
one-at-a-time encoder, a forced decoder prefix, beam search, and the
one-shot and prompt-permutation ensembles, members scored by summed
log-prob), prediction decoding, VQA metrics, and the deferred SmoothQuant
calibration of the int8 encoder modes. The model is built on the card
unless the caller passes ``device``; each batch's numpy arrays are moved
onto the model's device. On a mesh (``BaseExecutor._setup_mesh``) each
data rank generates its shard's questions with the T5 split over the model
axis; the predictions of each model group's first rank are gathered.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike
from ..ops.decoding import sequence_scores
from ..parallel.gather import gather_predictions_to_host0
from ..registry import EXECUTORS
from ..utils.attr_dict import AttrDict
from .base_executor import BaseExecutor, tree_to_device
from .model_factory import build_model_from_config

logger = logging.getLogger(__name__)

TABLE_COLUMNS = [
    "question_id", "image_key", "question", "input", "answers",
    "gold_answer", "prediction",
]


def ensemble_generate(
    model: Any,
    input_ids: torch.Tensor,        # (B, E, L)
    attention_mask: torch.Tensor,   # (B, E, L)
    clip_embeddings: torch.Tensor,
    num_ensembles: int,
    num_shots: Optional[int],
    no_prefix: bool,
    max_new_tokens: int,
    mode: str,
    num_beams: int = 1,
    members_per_call: int = 1,
) -> np.ndarray:
    """Generate each ensemble member, score each sequence by its summed
    token log-probs (skipping ids {0, 1, 2}) and keep, per question, the
    first member of the highest score (reference:
    few_shot_vqa_executor.py:293-332). Returns (B, T) tokens.

    ``mode`` "one_shot": member i pairs shot i's embedding with the test
    image's, ``clip_embeddings`` (B, shots + 1, size); "permutation":
    member i takes permutation i's whole set, (B, E, P, size). Beam
    outputs carry the winner's true per-token log-probs, so the ranking is
    the same for greedy and beam.

    ``members_per_call`` m (tpu.ensemble_members_per_call; 1 is the
    reference's per-member loop) folds m members into the batch of one
    generate call, question b's member j as row b * m + j: the decode's
    per-step costs are shared by m * B rows and the host waits once a
    call. Rows are independent, so the picks equal the loop's; each call's
    caches grow m-fold."""
    batch = input_ids.shape[0]
    members_per_call = max(1, min(members_per_call, num_ensembles))
    all_tokens, all_scores = [], []
    for start in range(0, num_ensembles, members_per_call):
        stop = min(start + members_per_call, num_ensembles)
        m = stop - start
        if mode == "one_shot":
            # (B, m, 2, size): one in-context embedding and the test image
            # (reference :298-299)
            shots = clip_embeddings[:, start:stop]
            test_img = clip_embeddings[:, -1:][:, None].expand(
                (batch, m, 1) + tuple(clip_embeddings.shape[2:]))
            member_clip = torch.cat([shots[:, :, None], test_img], dim=2)
        else:
            # permutation i's full embedding set (reference :301-302)
            member_clip = clip_embeddings[:, start:stop]
        member_clip = member_clip.reshape(
            (batch * m,) + tuple(member_clip.shape[2:]))
        tokens, logprobs = model.generate(
            prefix=member_clip,
            question_tokens=input_ids[:, start:stop].reshape(
                batch * m, input_ids.shape[-1]),
            question_mask=attention_mask[:, start:stop].reshape(
                batch * m, attention_mask.shape[-1]),
            no_prefix=no_prefix,
            num_shots=num_shots,
            max_new_tokens=max_new_tokens,
            num_beams=num_beams,
        )
        scores = sequence_scores(tokens, logprobs)
        tokens_np = tokens.cpu().numpy().reshape(batch, m, -1)
        scores_np = scores.cpu().numpy().reshape(batch, m)
        for j in range(m):
            all_tokens.append(tokens_np[:, j])
            all_scores.append(scores_np[:, j])
    best = np.argmax(np.stack(all_scores, axis=1), axis=1)     # (B,)
    return np.stack(all_tokens, axis=1)[np.arange(batch), best]


@EXECUTORS.register()
class FewShotVQAExecutor(BaseExecutor):
    """Eval-only executor: training_step is a no-op
    (reference: few_shot_vqa_executor.py:139-140)."""

    def __init__(self, config: Any, data_loader: Any,
                 device: DeviceLike = None):
        super().__init__(config, data_loader)
        self.model, self.model_kind = build_model_from_config(
            config, device=device)
        self._setup_mesh(self.model)
        # T5 has no BOS; the reference aliases it to pad
        # (few_shot_vqa_executor.py:62)
        if getattr(self.tokenizer, "bos_token", None) is None:
            self.tokenizer.bos_token = self.tokenizer.pad_token
        # the prefix-splice op keys on <extra_id_i> = sentinel_base - i and
        # cannot tell a wrong base from a prompt without prefixes, so check
        # the tokenizer/model agreement once at build time
        model_cfg = getattr(self.model, "cfg", None)
        sentinel_base = getattr(model_cfg, "sentinel_base", None)
        if sentinel_base is not None:
            try:
                tok_base = self.tokenizer.convert_tokens_to_ids(
                    "<extra_id_0>"
                )
            except Exception:
                tok_base = None
            if tok_base is not None and tok_base != sentinel_base:
                raise ValueError(
                    f"tokenizer maps <extra_id_0> to id {tok_base} but the "
                    f"model's sentinel_base is {sentinel_base}; set "
                    "model_config.model_args.sentinel_base to match the "
                    "tokenizer or prefixes will be silently dropped"
                )

    def _to_model(self, array: Any) -> torch.Tensor:
        return torch.as_tensor(array, device=self.model.device)

    def training_step(self, batch: AttrDict, batch_idx: int):
        return None

    def _maybe_calibrate_int8(self) -> None:
        """Deferred int8 quantization (tpu.int8_calibrate_batches > 0):
        pull the first N eval batches, accumulate SmoothQuant activation
        maxima on the spliced encoder inputs, then quantize the frozen
        LM with the calibrated folding
        (models/vct0.py::calibrate_and_quantize_int8). Runs once."""
        pending = getattr(self.model, "pending_int8_calibration", None)
        if not pending:
            return
        additional = self.config.data_loader.additional
        if additional.get("pass_examples_through_encoder_one_at_a_time", 0) \
                or bool(additional.get("ensemble_one_shots", 0)) \
                or int(additional.get(
                    "num_permutations_of_in_context_examples", 0)):
            raise ValueError(
                "tpu.int8_calibrate_batches supports the main/no_prefix "
                "eval modes; for one-at-a-time/ensemble modes calibrate "
                "via models.t5.calibrate_encoder_act_max and quantize "
                "before building the executor"
            )
        no_prefix = bool(additional.get("no_prefix", 0))
        n = int(pending["batches"])
        feed = []
        for idx, batch in enumerate(self.test_dataloader):
            if idx >= n:
                break
            feed.append({
                "prefix": self._to_model(batch.clip_embeddings),
                "question_tokens": self._to_model(
                    batch.generative_input_ids),
                "question_mask": self._to_model(
                    batch.generative_attention_mask),
                "no_prefix": no_prefix,
            })
        logger.info(
            "int8 SmoothQuant calibration on %d eval batch(es), alpha=%s",
            len(feed), pending["alpha"],
        )
        self.model.calibrate_and_quantize_int8(feed, alpha=pending["alpha"])
        self.model.pending_int8_calibration = None
        self._reshard_lm()

    def trainable_state(self) -> Dict[str, Any]:
        return {"mapper": self.model.params["mapper"]}

    def load_trainable_state(self, state: Dict[str, Any]) -> None:
        self.model.params["mapper"] = tree_to_device(state["mapper"],
                                                     self.model.device)

    # ------------------------------------------------------------------
    def _generative_step(self, batch: AttrDict, batch_idx: int) -> Dict:
        return self._collect_generative(
            self._dispatch_generative(batch, batch_idx)
        )

    def _dispatch_generative(self, batch: AttrDict, batch_idx: int) -> Dict:
        """Generate one eval batch's answers on the model's device (the
        device half of _generative_step; the JAX package's name)."""
        additional = self.config.data_loader.additional
        max_new = int(additional.max_target_length)
        num_shots = int(additional.get("num_shots", 0))
        one_at_a_time = bool(
            additional.get("pass_examples_through_encoder_one_at_a_time", 0)
        )
        num_perms = int(
            additional.get("num_permutations_of_in_context_examples", 0)
        )
        ensemble_one_shots = bool(additional.get("ensemble_one_shots", 0))
        no_prefix = bool(additional.get("no_prefix", 0))
        num_beams = int(additional.get("num_beams", 1))

        input_ids = self._to_model(batch.generative_input_ids)
        attention_mask = self._to_model(batch.generative_attention_mask)
        clip_embeddings = self._to_model(batch.clip_embeddings)

        def members(count: int) -> tuple:
            """The flat (B * count, L) prompts as (B, count, L)."""
            return (input_ids.reshape(-1, count, input_ids.shape[-1]),
                    attention_mask.reshape(-1, count,
                                           attention_mask.shape[-1]))

        decoder_input_ids = None
        if "decoder_generative_input_ids" in batch:
            # drop the trailing token like the reference (:182)
            decoder_input_ids = self._to_model(
                batch.decoder_generative_input_ids)[:, :-1]

        if one_at_a_time:
            # (reference: few_shot_vqa_executor.py:186-188)
            input_ids, attention_mask = members(num_shots + 1)
            tokens, _ = self.model.generate(
                prefix=clip_embeddings,
                question_tokens=input_ids,
                question_mask=attention_mask,
                no_prefix=no_prefix,
                pass_examples_through_encoder_one_at_a_time=True,
                max_new_tokens=max_new,
                num_beams=num_beams,
            )
        elif ensemble_one_shots or num_perms > 0:
            count = num_shots if ensemble_one_shots else num_perms
            input_ids, attention_mask = members(count)
            tokens = torch.from_numpy(self.generate_from_ensembles(
                input_ids, attention_mask, clip_embeddings,
                num_ensembles=count,
                num_shots=1 if ensemble_one_shots else None,
                no_prefix=no_prefix, max_new_tokens=max_new,
                mode="one_shot" if ensemble_one_shots else "permutation",
                num_beams=num_beams,
            ))
        else:
            tokens, _ = self.model.generate(
                prefix=clip_embeddings,
                question_tokens=input_ids,
                question_mask=attention_mask,
                decoder_input_ids=decoder_input_ids,
                no_prefix=no_prefix,
                max_new_tokens=max_new,
                num_beams=num_beams,
            )
        return {
            "tokens": tokens,
            "input_ids": input_ids,
            "batch": batch,
            "batch_idx": batch_idx,
        }

    def _collect_generative(self, state: Dict) -> Dict:
        """Fetch the batch's tokens to the host and build predictions and
        table rows (the host half of _generative_step)."""
        batch = state["batch"]
        batch_idx = state["batch_idx"]
        tokens_np = state["tokens"].cpu().numpy()
        input_ids = state["input_ids"].cpu().numpy()
        valid = np.asarray(
            batch.get("sample_valid", np.ones(len(tokens_np), dtype=bool))
        )

        predictions, table_entries = [], []
        lookup = self.data_loader.data.vqa_data.lookup
        for index, question_id in enumerate(batch.question_ids):
            if index >= len(tokens_np) or not valid[index]:
                continue
            decoded = self.decoder_tokenizer.decode(
                tokens_np[index].tolist(), skip_special_tokens=True
            )
            predictions.append(
                {"question_id": question_id, "answer": decoded}
            )
            item = lookup[str(question_id)]
            table_entries.append([
                question_id, item["img_key"], item["question"],
                self.tokenizer.decode(input_ids[index].reshape(-1).tolist()),
                item["answers"], item["gold_answer"], decoded,
            ])
        if batch_idx < 1 and predictions:
            logger.info(
                "sample prediction: %r <---> gold %r",
                predictions[0]["answer"], batch.gold_answers[0],
            )
        return {
            "predictions": predictions,
            "question_ids": list(batch.question_ids),
            "answers": list(batch.answers),
            "table_entries": table_entries,
        }

    def generate_from_ensembles(
        self,
        input_ids: torch.Tensor,        # (B, E, L)
        attention_mask: torch.Tensor,   # (B, E, L)
        clip_embeddings: torch.Tensor,
        num_ensembles: int,
        num_shots: Optional[int],
        no_prefix: bool,
        max_new_tokens: int,
        mode: str,
        num_beams: int = 1,
    ) -> np.ndarray:
        """:func:`ensemble_generate` with tpu.ensemble_members_per_call
        from the config (default 1, the reference's per-member loop)."""
        members_per_call = int(
            self.config.get("tpu", {}).get("ensemble_members_per_call", 1)
            or 1
        )
        return ensemble_generate(
            self.model, input_ids, attention_mask, clip_embeddings,
            num_ensembles=num_ensembles, num_shots=num_shots,
            no_prefix=no_prefix, max_new_tokens=max_new_tokens, mode=mode,
            num_beams=num_beams, members_per_call=members_per_call,
        )

    # ------------------------------------------------------------------
    def evaluate_outputs(self, step_outputs: List[Dict],
                         mode: str = "test") -> AttrDict:
        """Aggregate predictions + prediction table, compute metrics
        (reference: few_shot_vqa_executor.py:334-368). Over several
        processes each holds its shard's predictions: they are gathered
        first (``parallel/gather.py``; the identity in one process), since
        the VQA scorer needs every question."""
        predictions: List[Dict] = []
        rows: List[List] = []
        for i, out in enumerate(step_outputs):
            predictions.extend(out["predictions"])
            if i < 10:
                rows.extend(out["table_entries"])
        predictions = gather_predictions_to_host0(predictions)
        data = AttrDict(
            mode=mode,
            epoch=self.current_epoch,
            batch_predictions=predictions,
        )
        log_dict = self.compute_metrics(data)
        log_dict.artifacts["test_table"] = {
            "columns": TABLE_COLUMNS, "rows": rows,
        }
        return log_dict
