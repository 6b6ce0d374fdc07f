"""Write the RANDOM-baseline in-context example pickle.

Counterpart of
explicit_alignment_for_vqa_tasks_tpu/in_context_example_selection/make_random_examples.py
(reference: in_context_examples.py:221-304): draws k random train examples
per val question from the preprocessed train cache and writes
``random.pkl`` in the rices schema, equal to the JAX package's for the
same seed. Host code only.
"""

from __future__ import annotations

import argparse
import json
import logging
import pickle
from typing import List, Optional

logger = logging.getLogger(__name__)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_cache", required=True,
                        help="train_data_preprocessed.pkl")
    parser.add_argument("--val_questions", required=True,
                        help="v2_OpenEnded_mscoco_val2014_questions.json")
    parser.add_argument("--out", required=True)
    parser.add_argument("--num_examples", type=int, default=16)
    parser.add_argument("--seed", type=int, default=2021)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from .rices import random_examples
    from .run_rices import _load_cache

    train_items = _load_cache(args.train_cache)["data_items"]

    with open(args.val_questions, "r", encoding="utf-8") as fh:
        val_qids = [q["question_id"] for q in json.load(fh)["questions"]]

    out = random_examples(train_items, val_qids,
                          num_examples=args.num_examples, seed=args.seed)
    with open(args.out, "wb") as fh:
        pickle.dump(out, fh)
    logger.info("wrote %d random example lists to %s", len(out), args.out)


if __name__ == "__main__":
    main()
