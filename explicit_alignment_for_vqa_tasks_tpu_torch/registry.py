"""Named component registries.

The reference discovers every component by string -> ``globals()`` lookup,
powered by __init__.py files that import every class into module globals
(reference: src/main.py:77,170; src/trainers/__init__.py:1-11). We keep the
same config-facing contract (components referenced by class-name strings in
config files) but use explicit registries instead of import-side effects.

The port's own copy of
explicit_alignment_for_vqa_tasks_tpu/registry.py, held against it by
tests/test_torch_config.py.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, name: str = None) -> Callable:  # type: ignore[assignment]
        def deco(obj: Any) -> Any:
            key = name or getattr(obj, "__name__", str(obj))
            if key in self._items and self._items[key] is not obj:
                raise KeyError(f"duplicate {self.kind} registration: {key}")
            self._items[key] = obj
            return obj

        return deco

    def get(self, name: str) -> Any:
        try:
            return self._items[name]
        except KeyError as exc:
            known = ", ".join(sorted(self._items))
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {known}"
            ) from exc

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def names(self) -> list:
        return sorted(self._items)


DATA_LOADERS = Registry("data loader")
DATASETS = Registry("dataset")
EXECUTORS = Registry("executor")
MODELS = Registry("model")
METRICS = Registry("metric")
