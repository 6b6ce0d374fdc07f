"""Config loading and CLI override handling.

Mirrors the public behavior of the reference config system
(reference: src/utils/config_system.py:25-159): jsonnet config files with
``std.mergePatch`` inheritance, a fixed set of experiment flags copied into
``config.data_loader.additional``, dotted-path ``--opts a.b.c=value``
overrides, and derived experiment paths.

Deliberate departures from the reference (documented defects, SURVEY §2.3):
  * ``--opts`` values are parsed with ``ast.literal_eval`` (never ``eval``).
  * dotted paths may have any depth (the reference capped at 6).

The port's own copy of
explicit_alignment_for_vqa_tasks_tpu/utils/config_system.py, held against it by
tests/test_torch_config.py.
"""

from __future__ import annotations

import ast
import json
import os
from pathlib import Path
from typing import Any, List

from .attr_dict import AttrDict
from .jsonnet_eval import evaluate_file


def get_config_from_file(config_file: str) -> AttrDict:
    """Evaluate a jsonnet/json config file into an AttrDict."""
    return AttrDict(evaluate_file(config_file))


def process_config(args: Any) -> AttrDict:
    """Build the run config from parsed CLI args.

    `args` is an argparse.Namespace (or any object with the same attrs)
    produced by main.parse_args_sys.
    """
    config = get_config_from_file(args.config)
    repo_root = Path(__file__).resolve().parents[2]

    # Default top-level folders (reference: config_system.py:49-57)
    if not config.get("DATA_FOLDER"):
        config.DATA_FOLDER = str(repo_root.parent / "Data")
    if not config.get("EXPERIMENT_FOLDER"):
        config.EXPERIMENT_FOLDER = str(repo_root.parent / "Experiments")
    if not config.get("TENSORBOARD_FOLDER"):
        config.TENSORBOARD_FOLDER = str(repo_root.parent / "Data_TB" / "tb_logs")

    # Experiment flags threaded into the data layer
    # (reference: config_system.py:59-66)
    additional = config.data_loader.setdefault("additional", AttrDict())
    if getattr(args, "num_shots", -1) != -1:
        additional.num_shots = args.num_shots
    additional.no_prefix = getattr(args, "no_prefix", 0)
    additional.pass_examples_through_encoder_one_at_a_time = getattr(
        args, "pass_examples_through_encoder_one_at_a_time", 0
    )
    additional.num_permutations_of_in_context_examples = getattr(
        args, "num_permutations_of_in_context_examples", 0
    )
    additional.sample_templates = getattr(args, "sample_templates", 0)
    additional.ensemble_one_shots = getattr(args, "ensemble_one_shots", 0)
    if getattr(args, "in_context_examples_fpath", ""):
        modules = config.data_loader.setdefault("dataset_modules", AttrDict())
        module_dict = modules.setdefault("module_dict", AttrDict())
        lice = module_dict.setdefault("LoadInContextExamples", AttrDict())
        lice.setdefault("config", AttrDict()).file_path = (
            args.in_context_examples_fpath
        )

    # Direct overrides (reference: config_system.py:70-83)
    config.reset = getattr(args, "reset", False)
    config.mode = args.mode
    if getattr(args, "experiment_name", ""):
        config.experiment_name = args.experiment_name
    config.model_config.modules = list(config.model_config.get("modules", [])) + list(
        getattr(args, "modules", []) or []
    )
    if getattr(args, "test_batch_size", -1) != -1:
        config.test.batch_size = args.test_batch_size
    if getattr(args, "test_evaluation_name", ""):
        config.test.evaluation_name = args.test_evaluation_name

    config = parse_optional_args(config, getattr(args, "opts", []) or [])

    # Derived experiment paths (reference: config_system.py:99-110)
    exp = os.path.join(config.EXPERIMENT_FOLDER, config.experiment_name)
    config.experiment_path = exp
    config.log_path = os.path.join(exp, config.mode)
    config.saved_model_path = os.path.join(exp, "train", "saved_model")
    if config.mode == "train":
        config.imgs_path = os.path.join(exp, "train", "imgs")
    else:
        eval_name = config.test.get("evaluation_name", "test_evaluation")
        config.imgs_path = os.path.join(exp, "test", eval_name, "imgs")
        config.results_path = os.path.join(exp, "test", eval_name)
    config.tensorboard_path = os.path.join(
        config.TENSORBOARD_FOLDER, config.experiment_name
    )
    wandb_cfg = config.setdefault("WANDB", AttrDict())
    wandb_cfg.tags = list(wandb_cfg.get("tags", [])) + list(
        getattr(args, "tags", []) or []
    )

    # Record the raw args on the config for reproducibility
    config.args = AttrDict(
        {k: v for k, v in vars(args).items()} if hasattr(args, "__dict__") else {}
    )
    return config


def parse_opt_value(raw: str) -> Any:
    """Parse an --opts value: Python literal if possible, else string."""
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def set_by_dotted_path(config: AttrDict, path: str, value: Any) -> None:
    keys = path.split(".")
    node: Any = config
    for key in keys[:-1]:
        if key not in node or not isinstance(node[key], dict):
            node[key] = AttrDict()
        node = node[key]
    node[keys[-1]] = value


def parse_optional_args(config: AttrDict, opts: List[str]) -> AttrDict:
    """Apply ``--opts a.b.c=value ...`` dotted overrides
    (reference: src/utils/config_system.py:122-159, depth-unlimited here).
    """
    for opt in opts:
        if "=" not in opt:
            raise ValueError(f"--opts entries must be key=value, got {opt!r}")
        path, raw = opt.split("=", 1)
        set_by_dotted_path(config, path, parse_opt_value(raw))
    return config


def save_config(config: AttrDict, path: str) -> None:
    """Persist the fully-resolved config as JSON into the experiment dir
    (mirrors the reference's re-save of config.jsonnet, main.py:173-181)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(config.to_dict(), fh, indent=2, default=str)
