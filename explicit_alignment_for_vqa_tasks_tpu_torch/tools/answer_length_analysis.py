"""Answer-length and copy-from-shot analyses over prediction files.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/answer_length_analysis.py
(the reference's ``get_answer_length.ipynb``), host code only: the
distribution of predicted-answer word lengths in an ``answers.pkl`` (the
port's ``write_predictions_to_file``), and how often the predicted answer
copies a gold answer of one of the in-context examples (a ``rices.pkl``).

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.answer_length_analysis \
        --predictions answers.pkl [--in_context_examples rices.pkl --num_shots 4]
"""

from __future__ import annotations

import argparse
import json
import logging
import pickle
from collections import Counter
from typing import Dict

logger = logging.getLogger(__name__)


def analyse(
    predictions_path: str,
    in_context_examples_path: str = "",
    num_shots: int = 0,
) -> Dict:
    with open(predictions_path, "rb") as fh:
        predictions = pickle.load(fh)

    lengths = Counter(len(p["answer"].split()) for p in predictions)
    result: Dict = {
        "num_predictions": len(predictions),
        "answer_length_histogram": dict(sorted(lengths.items())),
        "mean_answer_length": (
            sum(len(p["answer"].split()) for p in predictions)
            / max(len(predictions), 1)
        ),
    }

    if in_context_examples_path and num_shots > 0:
        with open(in_context_examples_path, "rb") as fh:
            examples = pickle.load(fh)
        copied = 0
        covered = 0
        for pred in predictions:
            shots = examples.get(str(pred["question_id"]))
            if not shots:
                continue
            covered += 1
            shot_answers = {
                e["gold_answer"].strip().lower()
                for e in shots[-num_shots:]
            }
            if pred["answer"].strip().lower() in shot_answers:
                copied += 1
        result["copy_from_shot_rate"] = copied / max(covered, 1)
    return result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--predictions", required=True,
                        help="answers.pkl from write_predictions_to_file")
    parser.add_argument("--in_context_examples", default="")
    parser.add_argument("--num_shots", type=int, default=0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    result = analyse(args.predictions, args.in_context_examples,
                     args.num_shots)
    text = json.dumps(result, indent=2)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text)
    print(text)


if __name__ == "__main__":
    main()
