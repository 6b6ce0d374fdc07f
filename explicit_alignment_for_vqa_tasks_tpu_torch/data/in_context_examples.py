"""In-context example prompt formatting and selection.

Re-implements the prompt-template layer of the reference
(reference: src/utils/in_context_examples.py:64-218). The template STRINGS
are the behavior spec and must match the reference verbatim — few-shot VQA
accuracy depends on them — so they are reproduced exactly, including the
image slot being the T5 sentinel token ``<extra_id_{i}>``.

Note: the reference's own golden test for the ``*_no_prefix`` templates is
stale w.r.t. its implementation (the implementation appends "." to each
in-context gold answer on the no-prefix path,
reference: in_context_examples.py:178, while the test expects no period).
We follow the implementation, since the published baseline numbers were
produced by it.

The port's own copy of
explicit_alignment_for_vqa_tasks_tpu/data/in_context_examples.py, held
against it by tests/test_torch_eval_data.py: the global ``random`` and
``np.random`` streams that ``utils.seed.set_seed`` seeds draw the same
templates and examples in both packages.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Sequence, Union

import numpy as np

IMAGE_TOKEN = "<extra_id_{}>"

# Prompt templates (spec — verbatim from the reference,
# in_context_examples.py:117-135).
FORMATS: Dict[str, Union[str, List[str]]] = dict(
    default="{image_token}\n{question}\n{answer}",
    frozen="{image_token}\nQuestion: {question}\nAnswer: {answer}",
    hotpotqa="{image_token}\nCombine facts and answer this:\n{question}\n{answer}",
    extractive=(
        "Extract the answer to the question from the following context.\n"
        "Question: {question}\nContext: {image_token}"
    ),
    squad=(
        "Answer the question depending on the context.\n"
        "Context: {image_token};\nQuestion: {question};\nAnswer: {answer}"
    ),
    plain="{question}\nThe answer is\n{answer}",
    default_no_prefix="{question}\n{answer}",
    frozen_no_prefix="Question: {question}\nAnswer: {answer}",
    hotpotqa_no_prefix="Combine facts and answer this:\n{question}\n{answer}",
    squad_no_prefix=(
        "Answer the question depending on the context.\n"
        "Context: ;\nQuestion: {question};\nAnswer: {answer}"
    ),
    hotpotqa_list=[
        "{image_token}\nCombine facts and answer this:\n{question}\n{answer}",
        "{image_token}\nFormulate an answer to this elaborate question:\n"
        "{question}\n{answer}",
        "{image_token}\nHere's a complex question that requires someone to "
        "reason about the input, can you answer it?\n{question}\n{answer}",
    ],
)

# format types whose prompts carry a visual prefix slot
_WITH_PREFIX_TYPES = (
    "default", "frozen", "hotpotqa", "squad", "extractive", "hotpotqa_list"
)


class InContextExampleFormatter:
    """Formats k-shot prompts from retrieved in-context examples.

    Each example contributes one template instantiation with its own
    sentinel ``<extra_id_i>``; the test question takes ``<extra_id_k>``
    with an empty answer slot. Segments are joined with `sep_token`
    (or returned as a list in one-at-a-time encoder mode).
    """

    def __init__(
        self,
        format_type: str,
        sep_token: str = "\n",
        pass_examples_through_encoder_one_at_a_time: bool = False,
        sample_templates: bool = False,
        ensemble_one_shots: bool = False,
    ):
        self.format_type = format_type
        self.sep_token = sep_token
        self.one_at_a_time = pass_examples_through_encoder_one_at_a_time
        self.sample_templates = sample_templates
        self.ensemble_one_shots = ensemble_one_shots
        if sample_templates:
            self.template_list = FORMATS[format_type + "_list"]
            self.template = self.template_list[0]
        else:
            self.template = FORMATS[format_type]

    def format_input(
        self, in_context_examples: Sequence[Any], test_example: Any
    ) -> Union[str, List[str], List[List[str]]]:
        if self.sample_templates:
            # template sampling uses the global `random` stream, seeded by
            # the caller (parity with reference module_parser.py:80)
            self.template = random.choice(self.template_list)

        if self.ensemble_one_shots:
            return [
                self._format_with_prefix([example], test_example)
                for example in in_context_examples
            ]
        if self.format_type in _WITH_PREFIX_TYPES:
            return self._format_with_prefix(in_context_examples, test_example)
        return self._format_without_prefix(in_context_examples, test_example)

    def _format_with_prefix(self, examples: Sequence[Any], test_example: Any):
        segments = [
            self.template.format(
                image_token=IMAGE_TOKEN.format(i),
                question=_get(example, "question"),
                answer=_get(example, "gold_answer"),
            )
            for i, example in enumerate(examples)
        ]
        segments.append(
            self.template.format(
                image_token=IMAGE_TOKEN.format(len(examples)),
                question=_get(test_example, "question"),
                answer="",
            )
        )
        if self.one_at_a_time:
            return segments
        return self.sep_token.join(segments)

    def _format_without_prefix(self, examples: Sequence[Any], test_example: Any):
        # in-context answers get a trailing "." on the text-only path
        # (reference implementation behavior, in_context_examples.py:178)
        segments = [
            self.template.format(
                question=_get(example, "question"),
                answer=_get(example, "gold_answer") + ".",
            )
            for example in examples
        ]
        segments.append(
            self.template.format(
                question=_get(test_example, "question"), answer=""
            )
        )
        if self.one_at_a_time:
            return segments
        return self.sep_token.join(segments)


def _get(obj: Any, key: str) -> Any:
    if isinstance(obj, dict):
        return obj[key]
    return getattr(obj, key)


class InContextExampleSelector:
    """RANDOM-baseline example selector
    (reference: in_context_examples.py:64-111): draws k examples uniformly
    without replacement from the train split."""

    def __init__(
        self,
        num_in_context_examples: int,
        question_ids: List[int],
        vqa_data_items: List[Dict],
    ):
        self.num_in_context_examples = num_in_context_examples
        self.question_ids = question_ids
        self.by_question_id = {
            item["question_id"]: item for item in vqa_data_items
        }

    def get_random_examples(self) -> List[Dict]:
        chosen = np.random.choice(
            self.question_ids, size=self.num_in_context_examples, replace=False
        )
        return [
            {
                "question_id": self.by_question_id[qid]["question_id"],
                "img_key": self.by_question_id[qid]["img_key"],
                "question": self.by_question_id[qid]["question"],
                "gold_answer": self.by_question_id[qid]["gold_answer"],
            }
            for qid in chosen
        ]
