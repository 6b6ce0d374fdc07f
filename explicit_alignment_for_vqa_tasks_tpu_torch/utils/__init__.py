"""Host-side utilities of the port: the jsonnet evaluator and config
system, seeding, directories, the pickle cache and the loggers. Each is the
port's own copy of its namesake in explicit_alignment_for_vqa_tasks_tpu/utils/.
TPU-only knobs (``tpu_flags``, ``compilation_cache``) have no port."""

from .attr_dict import AttrDict
from .config_system import (
    get_config_from_file,
    parse_optional_args,
    process_config,
    save_config,
)
from .jsonnet_eval import evaluate_file, evaluate_snippet, merge_patch

__all__ = [
    "AttrDict",
    "get_config_from_file",
    "parse_optional_args",
    "process_config",
    "save_config",
    "evaluate_file",
    "evaluate_snippet",
    "merge_patch",
]
