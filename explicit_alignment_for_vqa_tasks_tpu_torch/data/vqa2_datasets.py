"""VQA2 dataset: sample assembly + ModuleParser-driven collation
(reference: src/data_loader_manager/datasets/vqa2_datasets.py:42-181).

The port's own copy of explicit_alignment_for_vqa_tasks_tpu/data/vqa2_datasets.py,
held against it by tests/test_torch_eval_data.py.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

from ..registry import DATASETS
from ..utils.attr_dict import AttrDict
from .module_parser import ModuleParser

logger = logging.getLogger(__name__)


@DATASETS.register()
class VQA2Dataset(ModuleParser):
    """Per-question samples with k retrieved in-context examples and their
    CLIP embeddings; collation runs the configured ModuleParser pipeline."""

    def __init__(self, config: Any, dataset_dict: Dict[str, Any]):
        self.config = config
        self.mode = dataset_dict["mode"]
        self.data = dataset_dict["data"]
        self.clip_embeddings = dataset_dict.get("clip_embeddings")
        self.in_context_examples = dataset_dict.get("in_context_examples") or {}
        self.answer_candidate_list = dataset_dict.get("answer_candidate_list")
        self.tokenizer = dataset_dict["tokenizer"]
        self.decoder_tokenizer = dataset_dict["decoder_tokenizer"]
        self.feature_extractor = dataset_dict.get("feature_extractor")
        self.image_preprocessor = dataset_dict.get("image_preprocessor")

    def __len__(self) -> int:
        return len(self.data.data_items)

    def __getitem__(self, idx: int) -> AttrDict:
        item = self.data.data_items[idx]
        num_shots = self.config.data_loader.additional.get("num_shots", 0)
        if num_shots == 0:
            in_context_examples: List[Any] = []
        else:
            # RICES lists are stored ascending by similarity, so the BEST
            # examples are at the END; [-k:] takes the top k
            # (reference: vqa2_datasets.py:73 +
            #  in_context_example_selection/get_average_similarities.py:46-62)
            examples = self.in_context_examples.get(str(item.question_id))
            if examples is None:
                raise KeyError(
                    f"no in-context examples for question "
                    f"{item.question_id}; check the LoadInContextExamples "
                    "file (--in_context_examples_fpath) or set num_shots=0"
                )
            in_context_examples = list(examples[-num_shots:])

        clip_embeddings = [
            self.clip_embeddings.get(str(_get(example, "img_key")))
            for example in in_context_examples
        ]
        clip_embeddings.append(self.clip_embeddings.get(str(item.img_key)))

        return AttrDict(
            question_id=item.question_id,
            question=item.question,
            img_key_full=item.img_key_full,
            img=item.get("img", []),
            gold_answer=item.gold_answer,
            answers=item.answers,
            clip_embedding=clip_embeddings,
            in_context_examples=in_context_examples,
        )

    def collate_fn(self, batch: List[AttrDict]) -> AttrDict:
        """Runs input/decoder_input/output module lists + post-processors
        over the batch, then appends meta fields
        (reference: vqa2_datasets.py:94-181)."""
        model_config = self.config.model_config
        groups = (
            ("input", model_config.input_modules),
            ("decoder_input", model_config.decoder_input_modules),
            ("output", model_config.output_modules),
        )

        batched = AttrDict(
            question_ids=[s.question_id for s in batch],
            questions=[s.question for s in batch],
            answers=[s.answers for s in batch],
            gold_answers=[s.gold_answer for s in batch],
        )
        for group_name, group_config in groups:
            collected = AttrDict()
            for sample in batch:
                parsed = self.parse_modules(
                    sample, group_config.module_list, type=group_name
                )
                for key, value in parsed.items():
                    collected.setdefault(key, []).append(value)
            processed = self.post_processing(
                collected, group_config.postprocess_module_list
            )
            batched.update(processed)
        return batched


def _get(obj: Any, key: str) -> Any:
    if isinstance(obj, dict):
        return obj[key]
    return getattr(obj, key)
