"""The port's trainers: the model factory, the eval executor
(``FewShotVQAExecutor``, registered in ``registry.EXECUTORS``) over
``BaseExecutor``'s eval loop, metrics and checkpointing. Training and the
other executors are not ported yet (ROADMAP.md, Queue 1 items 10 and 11)."""

from .base_executor import BaseExecutor
from .checkpointing import (
    get_checkpoint_model_path,
    load_checkpoint,
    save_checkpoint,
)
from .few_shot_vqa_executor import FewShotVQAExecutor
from .metrics_processors import MetricsProcessor, TextCleaner
from .model_factory import build_model_from_config

__all__ = [
    "BaseExecutor",
    "FewShotVQAExecutor",
    "MetricsProcessor",
    "TextCleaner",
    "build_model_from_config",
    "get_checkpoint_model_path",
    "load_checkpoint",
    "save_checkpoint",
]
