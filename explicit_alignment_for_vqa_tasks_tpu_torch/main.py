"""CLI entry point of the port.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/main.py (reference:
src/main.py:377-487 argparser, :69-197 orchestration), with the same
flags:

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.main \\
        configs/vqa2/few_shot_vqa_hotpotqa.jsonnet --mode test \\
        --num_shots 4 --in_context_examples_fpath .../rices.pkl \\
        --opts test.batch_size=32

Flow: evaluate the config -> build the data loader (registry by config
``data_loader.type``) -> build the executor (``train.type``), whose model
lives on the card -> load the checkpoint -> train (``--mode train``, e.g.
``configs/conceptual_captions/conceptual_captions.jsonnet``) or test. The
JAX package's TPU knobs (scoped VMEM, the XLA compilation cache) have no
counterpart, and its device statistics wait for Queue 1 item 15.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from logging.handlers import RotatingFileHandler
from typing import Any, Dict, List, Optional, Tuple

from . import data as _data  # noqa: F401 — populates DATA_LOADERS/DATASETS
from . import trainers as _trainers  # noqa: F401 — populates EXECUTORS
from .device import DeviceLike, world_size
from .registry import DATA_LOADERS, EXECUTORS
from .utils.color_logging import setup_console_logging
from .utils.config_system import process_config, save_config
from .utils.dirs import create_dirs
from .utils.loggers import MultiLogger
from .utils.seed import set_seed

logger = logging.getLogger(__name__)


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


def initialization(args: argparse.Namespace):
    """Config + dirs + logging (reference: src/main.py:200-374)."""
    config = process_config(args)
    dirs = [config.log_path, config.saved_model_path, config.imgs_path]
    if config.mode != "train":
        dirs.append(config.results_path)
    create_dirs(dirs)

    setup_console_logging()
    for level, name in ((logging.INFO, "info"), (logging.DEBUG, "debug"),
                        (logging.ERROR, "error")):
        handler = RotatingFileHandler(
            os.path.join(config.log_path, f"{name}.log"),
            maxBytes=10_000_000, backupCount=3,
        )
        handler.setLevel(level)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"
        ))
        logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.DEBUG)

    # unhandled-exception hook: log + close loggers cleanly
    # (reference: src/main.py:288-301)
    def excepthook(exc_type, exc_value, exc_tb):
        if issubclass(exc_type, KeyboardInterrupt):
            logger.warning("interrupted by user; shutting down loggers")
        else:
            logging.getLogger().critical(
                "unhandled exception", exc_info=(exc_type, exc_value, exc_tb)
            )
        sys.__excepthook__(exc_type, exc_value, exc_tb)

    sys.excepthook = excepthook

    save_config(config, os.path.join(config.experiment_path, "config.json"))
    return config


def main(config: Any, device: DeviceLike = None
         ) -> Tuple[Any, Dict[str, float]]:
    """Orchestration (reference: src/main.py:69-197). The model is built
    on ``device``, the card unless the caller passes another. Returns the
    executor and the test metrics (none for a train run)."""
    world_size()  # one process: more raise (the JAX package starts them here)
    set_seed(int(config.get("seed", 2021)))

    data_loader_cls = DATA_LOADERS.get(config.data_loader.type)
    data_loader = data_loader_cls(config)
    data_loader.build_dataset()
    data_loader.set_dataloader()

    executor_cls = EXECUTORS.get(config.train.type)
    executor = executor_cls(config, data_loader, device=device)

    multi_logger = MultiLogger(
        config,
        use_wandb=not config.get("args", {}).get("disable_wandb", False),
        use_tb=not config.get("args", {}).get("disable_tensorboard", False),
    )
    executor.setup(multi_logger)

    try:
        executor.maybe_load_checkpoint()
        if config.mode == "train":
            executor.train()
            return executor, {}
        return executor, executor.test()
    finally:
        multi_logger.close()


def _close_file_handlers() -> None:
    root = logging.getLogger()
    for handler in list(root.handlers):
        if isinstance(handler, RotatingFileHandler):
            root.removeHandler(handler)
            handler.close()


def run(argv: Optional[List[str]] = None, device: DeviceLike = None
        ) -> Tuple[Any, Dict[str, float]]:
    args = parse_args_sys(argv)
    config = initialization(args)
    try:
        return main(config, device=device)
    finally:
        _close_file_handlers()


if __name__ == "__main__":
    run(sys.argv[1:])
