"""Attribute-access dict (replacement for the reference's EasyDict dependency).

The reference threads an EasyDict config through every object
(reference: src/utils/config_system.py:35-37). We provide our own small
implementation so the framework has zero dependency on `easydict`.

The port's own copy of
explicit_alignment_for_vqa_tasks_tpu/utils/attr_dict.py, held against it by
tests/test_torch_config.py.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping


class AttrDict(dict):
    """A dict whose items are also attributes, applied recursively.

    >>> c = AttrDict({"train": {"batch_size": 32}})
    >>> c.train.batch_size
    32
    >>> c.train.lr = 1e-4
    >>> c["train"]["lr"]
    0.0001
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__()
        for source in args:
            if source is None:
                continue
            items: Iterable = (
                source.items() if isinstance(source, Mapping) else source
            )
            for key, value in items:
                self[key] = value
        for key, value in kwargs.items():
            self[key] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Mapping) and not isinstance(value, AttrDict):
            return AttrDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(AttrDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key: Any, value: Any) -> None:
        super().__setitem__(key, AttrDict._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as exc:  # AttributeError so hasattr() works
            raise AttributeError(key) from exc

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def setdefault(self, key: Any, default: Any = None) -> Any:
        if key not in self:
            self[key] = default
        return self[key]

    def update(self, *args: Any, **kwargs: Any) -> None:  # type: ignore[override]
        for source in args:
            items = source.items() if isinstance(source, Mapping) else source
            for key, value in items:
                self[key] = value
        for key, value in kwargs.items():
            self[key] = value

    def copy(self) -> "AttrDict":
        return AttrDict(self)

    def to_dict(self) -> dict:
        """Plain-dict deep copy (for JSON serialization)."""

        def unwrap(value: Any) -> Any:
            if isinstance(value, Mapping):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                return [unwrap(v) for v in value]
            return value

        return unwrap(self)
