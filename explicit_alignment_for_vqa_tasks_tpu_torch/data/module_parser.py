"""Declarative feature-assembly mixin (the "ModuleParser").

Re-implements the reference's declarative data pipeline
(reference: src/data_loader_manager/module_parser.py:9-604): config lists
name sample-level parser modules (QInput, EmbeddingInput, ...) and batch
post-processors (tokenization, embedding stacking, ...); the Dataset class
mixes this in and drives it from its collate function.

Tokenized batches are padded to BUCKETED LENGTHS
(``config.tpu.length_buckets``) instead of ``padding='longest'``, so the
model sees a small closed set of shapes, as in the JAX package. Attention
masks make this semantics-preserving. All outputs are numpy (host) arrays;
the executor moves them to the model's device.

The port's own copy of explicit_alignment_for_vqa_tasks_tpu/data/module_parser.py,
held against it by tests/test_torch_eval_data.py.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..utils.attr_dict import AttrDict
from .in_context_examples import InContextExampleFormatter


def pick_bucket(length: int, buckets: Optional[Sequence[int]], cap: int) -> int:
    """Smallest bucket >= length, else cap; lengths above cap stay capped."""
    length = min(length, cap)
    if buckets:
        for b in sorted(buckets):
            if length <= b <= cap:
                return b
    return cap


def pad_to_length(
    arr: np.ndarray, target: int, pad_value: int, side: str = "right"
) -> np.ndarray:
    """Pad the last axis of `arr` out to `target` with `pad_value`."""
    cur = arr.shape[-1]
    if cur >= target:
        return arr
    pad_width = [(0, 0)] * (arr.ndim - 1)
    pad_width.append((target - cur, 0) if side == "left" else (0, target - cur))
    return np.pad(arr, pad_width, constant_values=pad_value)


class ModuleParser:
    """Mixin: parses samples into model inputs per the config module lists.

    Host classes must provide `self.config`, `self.tokenizer`,
    `self.decoder_tokenizer` (and `self.image_preprocessor` if image
    modules are used).
    """

    # ------------------------------------------------------------------
    # Sample-level parsers (each returns a dict of fields for one sample)
    # ------------------------------------------------------------------

    def QuestionInput(self, sample: Any, module: Any) -> AttrDict:
        """Bare question wrapped in separation tokens
        (reference: module_parser.py:29-45)."""
        seq = " ".join(
            [module.separation_tokens.start, sample.question,
             module.separation_tokens.end]
        )
        return AttrDict(text_sequence=seq)

    def QAInput(self, sample: Any, module: Any) -> AttrDict:
        """question + BOS + answer + EOS (reference: module_parser.py:47-66)."""
        seq = " ".join(
            [module.separation_tokens.start, sample.question,
             module.separation_tokens.end, self.tokenizer.bos_token,
             sample.gold_answer, self.tokenizer.eos_token]
        )
        return AttrDict(text_sequence=seq)

    def QInput(self, sample: Any, module: Any) -> AttrDict:
        """Few-shot prompt via InContextExampleFormatter, with optional
        permutation ensembling (reference: module_parser.py:68-93)."""
        additional = self.config.data_loader.additional
        formatter = InContextExampleFormatter(
            format_type=module.option,
            pass_examples_through_encoder_one_at_a_time=additional.get(
                "pass_examples_through_encoder_one_at_a_time", 0
            ),
            sample_templates=additional.get("sample_templates", 0),
            ensemble_one_shots=additional.get("ensemble_one_shots", 0),
        )
        num_perms = additional.get(
            "num_permutations_of_in_context_examples", 0
        )
        if num_perms > 0:
            # fixed seed so example order is reproducible across runs
            # (parity with reference module_parser.py:80)
            random.seed(2022)
            formatted = [
                formatter.format_input(
                    random.sample(
                        list(sample.in_context_examples),
                        k=len(sample.in_context_examples),
                    ),
                    sample,
                )
                for _ in range(num_perms)
            ]
        else:
            formatted = formatter.format_input(
                list(sample.in_context_examples), sample
            )
        return AttrDict(text_sequence=formatted)

    def TestInput(self, sample: Any, module: Any) -> AttrDict:
        """Zero-shot prompt (no in-context examples)
        (reference: module_parser.py:95-110)."""
        additional = self.config.data_loader.additional
        formatter = InContextExampleFormatter(
            format_type=module.option,
            pass_examples_through_encoder_one_at_a_time=additional.get(
                "pass_examples_through_encoder_one_at_a_time", 0
            ),
            sample_templates=additional.get("sample_templates", 0),
            ensemble_one_shots=additional.get("ensemble_one_shots", 0),
        )
        return AttrDict(text_sequence=formatter.format_input([], sample))

    def SummaryInput(self, sample: Any, module: Any) -> AttrDict:
        """Captioning prompt: a single sentinel slot
        (reference: module_parser.py:113-129)."""
        return AttrDict(text_sequence="<extra_id_0>")

    def TextBasedVisionInput(self, sample: Any, module: Any) -> AttrDict:
        """Textual rendering of visual detections
        (reference: module_parser.py:172-232): object classes with
        thresholded attributes, de-duplicated OCR strings, or captions."""
        if module.option == "object":
            sentences: List[str] = [module.separation_tokens.start]
            for obj in sample.objects:
                attribute_max = module.get("attribute_max", 0)
                if attribute_max > 0:
                    kept = []
                    for attr, score in zip(
                        obj["attributes"], obj["attribute_scores"]
                    ):
                        if (
                            score > module.attribute_thres
                            and len(kept) < attribute_max
                        ):
                            kept.append(attr)
                    sentences.extend(kept)
                sentences.append(obj["class"])
                sentences.append(module.separation_tokens.sep)
            if module.get("ocr", 0) > 0:
                seen: List[str] = []
                for annotation in sample.img_ocr:
                    description = (
                        annotation["description"].strip().replace("\n", " ")
                    )
                    if description not in seen:
                        seen.append(description)
                sentences.extend(seen)
            sentences.append(module.separation_tokens.end)
            return AttrDict(text_sequence=" ".join(sentences))
        elif module.option == "caption":
            return AttrDict(
                text_sequence=" ".join(
                    [module.separation_tokens.start,
                     sample.img_caption["caption"],
                     module.separation_tokens.end]
                )
            )
        return AttrDict(text_sequence="")

    def EmbeddingInput(self, sample: Any, module: Any) -> AttrDict:
        """Stack the sample's CLIP embeddings (k shots + test image), with
        optional permutations (reference: module_parser.py:234-260)."""
        additional = self.config.data_loader.additional
        num_perms = additional.get(
            "num_permutations_of_in_context_examples", 0
        )
        embeddings = [np.asarray(e, dtype=np.float32) for e in
                      sample.clip_embedding]
        if num_perms > 0:
            in_context = embeddings[:-1]
            random.seed(2022)
            permuted = [
                [*random.sample(in_context, k=len(in_context)), embeddings[-1]]
                for _ in range(num_perms)
            ]
            stacked = np.stack(
                [e.reshape(-1) for perm in permuted for e in perm]
            ).reshape(num_perms, len(embeddings), -1)
            return AttrDict(clip_embedding=stacked)
        return AttrDict(
            clip_embedding=np.stack([e.reshape(-1) for e in embeddings])
        )

    def ImageInput(self, sample: Any, module: Any) -> AttrDict:
        return AttrDict(img=sample.img)

    def GenerationOutput(self, sample: Any, module: Any) -> AttrDict:
        """Target text = gold answer (reference: module_parser.py:275-286)."""
        return AttrDict(text_sequence=sample.gold_answer)

    def KnowledgeInput(self, sample: Any, module: Any) -> AttrDict:
        return AttrDict(
            text_sequence=" ".join(
                [module.separation_tokens.start, sample.passage_content,
                 module.separation_tokens.end]
            )
        )

    def SimilarityOutput(self, sample: Any, module: Any) -> AttrDict:
        """1 for the gold passage, 0 for negatives
        (reference: module_parser.py:304-315)."""
        return AttrDict(label=[1] + [0] * len(sample.neg_passage_ids))

    # ------------------------------------------------------------------
    # Drivers
    # ------------------------------------------------------------------

    def parse_modules(
        self,
        sample: Any,
        modules: Sequence[Any],
        type: str,  # noqa: A002 — name kept for config-surface parity
        process_modules: Optional[Sequence[Any]] = None,
    ) -> AttrDict:
        if type not in ("input", "decoder_input", "output"):
            raise ValueError(f"unknown module group: {type}")
        collected = [
            getattr(self, module.type)(sample, module) for module in modules
        ]
        if process_modules is None:
            return self.DefaultProcessing(collected)
        processed: Any = collected
        for process_module in process_modules:
            processed = getattr(self, process_module.type)(processed)
        return processed

    def DefaultProcessing(self, data_to_process: Sequence[Dict]) -> AttrDict:
        """Merge per-module fields; same-key strings concatenate with ' '
        (reference: module_parser.py:366-384)."""
        merged = AttrDict()
        for entry in data_to_process:
            for key, value in entry.items():
                if key not in merged:
                    merged[key] = value
                elif isinstance(value, str):
                    merged[key] = merged[key] + " " + value
                else:
                    raise TypeError(
                        f"cannot merge non-string field {key!r} of type "
                        f"{type(value)}"
                    )
        return merged

    # ------------------------------------------------------------------
    # Batch post-processors
    # ------------------------------------------------------------------

    def _length_buckets(self) -> Optional[List[int]]:
        tpu_cfg = self.config.get("tpu", {})
        return list(tpu_cfg.get("length_buckets", [])) or None

    def _tokenize_bucketed(
        self, texts: List[str], tokenizer: Any, max_length: int,
        padding_side: Optional[str] = None,
    ) -> Dict[str, np.ndarray]:
        # padding_side rides as a CALL kwarg rather than mutating
        # tokenizer state: collate runs on a thread pool and HF fast
        # tokenizers share Rust state ("Already borrowed" under races)
        enc = tokenizer(
            texts,
            padding="longest",
            max_length=max_length,
            truncation=True,
            return_tensors="np",
            **({"padding_side": padding_side} if padding_side else {}),
        )
        input_ids = np.asarray(enc["input_ids"])
        attention_mask = np.asarray(enc["attention_mask"])
        target = pick_bucket(input_ids.shape[-1], self._length_buckets(),
                             max_length)
        side = padding_side or getattr(tokenizer, "padding_side", "right")
        pad_id = tokenizer.pad_token_id
        if pad_id is None:
            pad_id = 0
        return {
            "input_ids": pad_to_length(input_ids, target, pad_id, side),
            "attention_mask": pad_to_length(attention_mask, target, 0, side),
        }

    def PostProcessInputTokenization(
        self, data_to_process: AttrDict, module: Any
    ) -> AttrDict:
        """Tokenize input text (reference: module_parser.py:386-450).
        option 'generation' namespaces outputs as generative_*;
        'decoder_generation' pads on the left with a '<pad>' prefix for
        decoder-only models."""
        assert "text_sequence" in data_to_process
        text_sequences = data_to_process.pop("text_sequence")
        additional = self.config.data_loader.additional
        max_len = additional.max_source_length
        task_prefix = ""

        padding_side = None
        if module.option == "decoder_generation":
            padding_side = "left"
            task_prefix = "<pad>"

        multi_sequence = (
            additional.get("pass_examples_through_encoder_one_at_a_time", 0)
            or additional.get("num_permutations_of_in_context_examples", 0) > 0
            or additional.get("ensemble_one_shots", 0)
        )
        if multi_sequence:
            flat = [seg for seqs in text_sequences for seg in seqs]
            encoding = self._tokenize_bucketed(
                flat, self.tokenizer, max_len, padding_side=padding_side
            )
        else:
            encoding = self._tokenize_bucketed(
                [task_prefix + seq for seq in text_sequences],
                self.tokenizer, max_len, padding_side=padding_side,
            )

        if module.option == "generation":
            for key, value in encoding.items():
                data_to_process[f"generative_{key}"] = value
            data_to_process["generative_text_sequences"] = text_sequences
        elif module.option == "decoder_generation":
            for key, value in encoding.items():
                data_to_process[f"decoder_generative_{key}"] = value
            data_to_process["decoder_generative_text_sequences"] = (
                text_sequences
            )
        else:
            data_to_process.update(encoding)
            data_to_process["input_text_sequences"] = text_sequences
        return data_to_process

    def PreProcessImage(self, data_to_process: AttrDict, module: Any) -> AttrDict:
        """Image preprocessing for pixel-input models
        (reference: module_parser.py:452-464)."""
        assert "img" in data_to_process
        imgs = data_to_process.pop("img")
        processed = self.image_preprocessor(imgs)
        if isinstance(processed, dict):
            data_to_process.update(processed)
        else:
            data_to_process["pixel_values"] = np.asarray(processed)
        return data_to_process

    def PostProcessClipEmbeddings(
        self, data_to_process: AttrDict, module: Any
    ) -> AttrDict:
        """Stack per-sample CLIP embeddings into one batch array
        (reference: module_parser.py:466-478)."""
        assert "clip_embedding" in data_to_process
        embeddings = data_to_process.pop("clip_embedding")
        data_to_process["clip_embeddings"] = np.stack(
            [np.asarray(e, dtype=np.float32) for e in embeddings]
        )
        return data_to_process

    def PostProcessDecoderInputTokenization(
        self, data_to_process: AttrDict
    ) -> AttrDict:
        """Tokenize decoder input text (reference: module_parser.py:480-502)."""
        assert "text_sequence" in data_to_process
        text_sequences = data_to_process.pop("text_sequence")
        encoding = self._tokenize_bucketed(
            list(text_sequences),
            self.decoder_tokenizer,
            self.config.data_loader.additional.max_decoder_source_length,
        )
        data_to_process.update(
            {
                "decoder_input_ids": encoding["input_ids"],
                "decoder_input_attention_mask": encoding["attention_mask"],
                "decoder_input_text_sequences": text_sequences,
            }
        )
        return data_to_process

    def PostProcessOutputTokenization(
        self, data_to_process: AttrDict, module: Any
    ) -> AttrDict:
        """Tokenize targets into labels. The FIRST pad in each row is kept
        (it doubles as EOS for pad==eos vocabularies); later pads become
        -100 (ignored by the loss). Reference: module_parser.py:504-563."""
        assert "text_sequence" in data_to_process
        text_sequences = data_to_process.pop("text_sequence")
        max_target = self.config.data_loader.additional.max_target_length
        tokenizer = self.decoder_tokenizer
        enc = tokenizer(
            list(text_sequences),
            padding="max_length",
            max_length=max_target,
            truncation=True,
            return_tensors="np",
        )
        output_ids = np.asarray(enc["input_ids"], dtype=np.int64)
        output_mask = np.asarray(enc["attention_mask"], dtype=np.int64)

        pad_id = tokenizer.pad_token_id
        is_pad = output_ids == pad_id
        # position of the first pad per row; keep it, mask the rest
        first_pad = np.where(
            is_pad.any(axis=-1), is_pad.argmax(axis=-1), output_ids.shape[-1]
        )
        col = np.arange(output_ids.shape[-1])[None, :]
        mask_after_first_pad = is_pad & (col > first_pad[:, None])
        labels = np.where(mask_after_first_pad, -100, output_ids)

        data_to_process.update(
            {
                "labels": labels,
                "output_sequence_ids": output_ids,
                "output_sequence_attention_mask": output_mask,
                "output_text_sequences": text_sequences,
            }
        )
        return data_to_process

    def PostProcessConcatenateLabels(self, data_to_process: AttrDict) -> AttrDict:
        """Flatten per-sample label lists (reference: module_parser.py:565-581)."""
        assert "label" in data_to_process
        label_lists = data_to_process.pop("label")
        flat: List[int] = []
        for lbl in label_lists:
            flat.extend(lbl)
        data_to_process["labels"] = np.asarray(flat, dtype=np.int64)
        return data_to_process

    def post_processing(
        self,
        processed_batch_data: AttrDict,
        postprocess_modules: Optional[Sequence[Any]] = None,
    ) -> AttrDict:
        """Run configured batch post-processors in order
        (reference: module_parser.py:583-604)."""
        if not postprocess_modules:
            return processed_batch_data
        out = processed_batch_data
        for module in postprocess_modules:
            func = getattr(self, module.type)
            out = func(out, module)
        return out
