"""Pickle cache for preprocessed data (reference: src/utils/cache_system.py:9-67).

Preprocessed splits (e.g. VQA2 data_items) are cached under
``config.cache.default_folder`` keyed by name; per-key ``regenerate``
flags in ``config.cache.regenerate`` force a rebuild.

The port's own copy of
explicit_alignment_for_vqa_tasks_tpu/utils/cache_system.py, held against it by
tests/test_torch_config.py.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Any, Optional

logger = logging.getLogger(__name__)


def _cache_path(cache_folder: str, name: str) -> str:
    return os.path.join(cache_folder, f"{name}.pkl")


def save_cached_data(config: Any, data: Any, name: str) -> str:
    """Pickle `data` under the configured cache folder, keyed by `name`.

    Stored wrapped as ``{"cache": data}`` — the reference's on-disk layout
    (reference: cache_system.py:24-26), so cache files interoperate with
    reference runs and its offline scripts."""
    folder = config.cache.default_folder
    os.makedirs(folder, exist_ok=True)
    path = _cache_path(folder, name)
    with open(path, "wb") as fh:
        pickle.dump({"cache": data}, fh, protocol=pickle.HIGHEST_PROTOCOL)
    logger.info("cached %s -> %s", name, path)
    return path


def load_cached_data(config: Any, name: str) -> Optional[Any]:
    """Load cached data by name; returns None on miss or forced regenerate."""
    regenerate = bool(config.cache.get("regenerate", {}).get(name, 0))
    if regenerate:
        logger.info("cache regenerate forced for %s", name)
        return None
    path = _cache_path(config.cache.default_folder, name)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as fh:
            data = pickle.load(fh)
        if isinstance(data, dict) and set(data) == {"cache"}:
            data = data["cache"]  # reference wrapper format
        logger.info("cache hit for %s (%s)", name, path)
        return data
    except Exception as exc:  # corrupt cache: treat as a miss
        logger.warning("failed to load cache %s: %s", path, exc)
        return None
