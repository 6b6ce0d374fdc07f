"""The port's trainers: the model factory, the executors (registered in
``registry.EXECUTORS``: ``FewShotVQAExecutor``, the eval; ``VCT0Executor``,
mapper training on Conceptual Captions; ``ClipCapExecutor``, which raises
until ROADMAP.md Queue 1 item 11) over ``BaseExecutor``'s run loop, the
optimizer, metrics and checkpointing."""

from .base_executor import BaseExecutor
from .clipcap_executor import ClipCapExecutor
from .checkpointing import (
    get_checkpoint_model_path,
    load_checkpoint,
    save_checkpoint,
)
from .few_shot_vqa_executor import FewShotVQAExecutor
from .metrics_processors import MetricsProcessor, TextCleaner
from .model_factory import build_model_from_config
from .optimization import MultiStepAdamW, make_optimizer, make_schedule
from .vct0_executor import VCT0Executor

__all__ = [
    "BaseExecutor",
    "ClipCapExecutor",
    "FewShotVQAExecutor",
    "MetricsProcessor",
    "MultiStepAdamW",
    "TextCleaner",
    "VCT0Executor",
    "build_model_from_config",
    "get_checkpoint_model_path",
    "load_checkpoint",
    "make_optimizer",
    "make_schedule",
    "save_checkpoint",
]
