"""CLI entry point of the port.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/main.py: the same
flags and the same parser (``parse_args_sys``), whose namespace
``utils.config_system.process_config`` turns into the run's config, and
``trainers.model_factory.build_model_from_config`` into its model:

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.main \\
        configs/vqa2/few_shot_vqa_hotpotqa.jsonnet --mode test \\
        --num_shots 4 --opts test.batch_size=32

The data loaders and executors that ``main`` runs are not ported yet
(ROADMAP.md, Queue 1 item 7 steps (c) and (d)), so ``main`` and ``run``
raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, List, Optional


def parse_args_sys(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="TPU-native explicit-alignment few-shot VQA framework"
    )
    parser.add_argument("config", help="jsonnet/json config file")
    parser.add_argument("--mode", choices=["train", "test"], default="train")
    parser.add_argument("--experiment_name", type=str, default="")
    parser.add_argument("--reset", action="store_true",
                        help="wipe the experiment dir before starting")
    parser.add_argument("--num_shots", type=int, default=-1)
    parser.add_argument("--no_prefix", type=int, default=0)
    parser.add_argument(
        "--pass_examples_through_encoder_one_at_a_time", type=int, default=0
    )
    parser.add_argument(
        "--num_permutations_of_in_context_examples", type=int, default=0
    )
    parser.add_argument("--sample_templates", type=int, default=0)
    parser.add_argument("--ensemble_one_shots", type=int, default=0)
    parser.add_argument("--in_context_examples_fpath", type=str, default="")
    parser.add_argument("--test_batch_size", type=int, default=-1)
    parser.add_argument("--test_evaluation_name", type=str, default="")
    parser.add_argument("--modules", nargs="*", default=[])
    parser.add_argument("--tags", nargs="*", default=[])
    parser.add_argument("--log_prediction_tables", action="store_true")
    parser.add_argument("--disable_wandb", action="store_true")
    parser.add_argument("--disable_tensorboard", action="store_true")
    parser.add_argument(
        "--opts", nargs="*", default=[],
        help="dotted-path config overrides: a.b.c=value",
    )
    return parser.parse_args(argv)


def main(config: Any) -> None:
    raise NotImplementedError(
        "main: the data loaders and executors are not ported yet "
        "(ROADMAP.md, Queue 1 item 7 steps (c) and (d)); build the model "
        "with trainers.model_factory.build_model_from_config")


def run(argv: Optional[List[str]] = None) -> None:
    parse_args_sys(argv)
    main(None)


if __name__ == "__main__":
    run(sys.argv[1:])
