"""Time the port's VQA scorer (utils/vqa_eval.py) at the size of VQA2 val
on the host's CPU, beside the official code's loop shape.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.time_vqa_scoring \
        [--questions 214354] [--seed 0]

The questions are synthetic: ten answers each, drawn Zipf-like from a
vocabulary of 30,000 answers (VQA2 val has tens of thousands of distinct
answers, a few of them very frequent), with three in ten questions
unanimous, so that both branches of the protocol run. ``official_shape_s``
is the same protocol scored as the official code does it: every answer of
every question normalized, and the other annotators' matches counted for
each annotator. Its accuracies must equal the scorer's bit for bit. Prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import platform
import time
from typing import List

import numpy as np

from ..utils.vqa_eval import (
    VQAEval,
    _clean_ws,
    process_digit_article,
    process_punctuation,
)

VQA2_VAL_QUESTIONS = 214354


class _Answers:
    """The ``qa`` table and ``get_ques_ids`` that VQAEval reads of VQA."""

    def __init__(self, qa: dict):
        self.qa = qa

    def get_ques_ids(self) -> List[int]:
        return list(self.qa)


def synthetic_val(n: int, seed: int):
    rng = np.random.default_rng(seed)
    vocab = ["yes", "no", "2", "two", "the dog", "blue.", "none", "dont",
             "man's", "black,"] + [f"word{i} thing{i % 97}"
                                   for i in range(30000)]

    def draw(k: int) -> List[str]:
        return [vocab[i] for i in
                np.minimum(rng.zipf(1.3, k) - 1, len(vocab) - 1)]

    gt, res = {}, {}
    types = (("what color is", "other"), ("how many", "number"),
             ("is the", "yes/no"))
    for q in range(n):
        answers = draw(1) * 10 if rng.random() < 0.3 else draw(10)
        qtype, atype = types[q % 3]
        gt[q] = {"answers": [{"answer": a} for a in answers],
                 "question_type": qtype, "answer_type": atype}
        res[q] = {"answer": draw(1)[0]}
    return _Answers(gt), _Answers(res)


def official_shape(vqa, res) -> List[float]:
    out = []
    for qid in vqa.get_ques_ids():
        res_ans = _clean_ws(res.qa[qid]["answer"])
        gt_answers = [_clean_ws(a["answer"]) for a in vqa.qa[qid]["answers"]]
        if len(set(gt_answers)) > 1:
            gt_answers = [process_digit_article(process_punctuation(a))
                          for a in gt_answers]
            res_ans = process_digit_article(process_punctuation(res_ans))
        per_annotator = []
        for i in range(len(gt_answers)):
            matches = sum(1 for j, other in enumerate(gt_answers)
                          if j != i and other == res_ans)
            per_annotator.append(min(1.0, matches / 3.0))
        out.append(sum(per_annotator) / len(per_annotator))
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--questions", type=int, default=VQA2_VAL_QUESTIONS)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    vqa, res = synthetic_val(args.questions, args.seed)
    ev = VQAEval(vqa, res, n=2)
    t0 = time.perf_counter()
    ev.evaluate()
    evaluate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = ev._per_question_accuracies(vqa.get_ques_ids())
    scorer_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = official_shape(vqa, res)
    official_s = time.perf_counter() - t0
    if scores != want:
        raise AssertionError("the scorer's accuracies differ from the "
                             "official loop's")
    out = {"questions": args.questions, "evaluate_s": evaluate_s,
           "per_question_s": scorer_s, "official_shape_s": official_s,
           "accuracy_overall": ev.accuracy["overall"],
           "cpu": platform.processor() or platform.machine()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
