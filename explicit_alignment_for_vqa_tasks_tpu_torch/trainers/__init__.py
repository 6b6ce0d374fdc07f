"""The port's trainers: so far the model factory
(``build_model_from_config``); the executors come with ROADMAP.md Queue 1
item 7 steps (c) and (d)."""

from .model_factory import build_model_from_config

__all__ = ["build_model_from_config"]
