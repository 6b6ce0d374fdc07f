"""Directory helpers (reference: src/utils/dirs.py:7-43).

The port's own copy of
explicit_alignment_for_vqa_tasks_tpu/utils/dirs.py, held against it by
tests/test_torch_config.py.
"""

from __future__ import annotations

import logging
import os
import shutil
import zipfile
from typing import Iterable

logger = logging.getLogger(__name__)


def create_dirs(dirs: Iterable[str]) -> None:
    """Create each directory if missing."""
    for d in dirs:
        os.makedirs(d, exist_ok=True)


def delete_dir(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
        logger.info("deleted directory %s", path)


def reset_dir(path: str) -> None:
    delete_dir(path)
    os.makedirs(path, exist_ok=True)


def zip_dir(src_dir: str, dst_zip: str) -> None:
    """Zip a directory tree into dst_zip."""
    with zipfile.ZipFile(dst_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _, files in os.walk(src_dir):
            for name in files:
                full = os.path.join(root, name)
                zf.write(full, os.path.relpath(full, src_dir))
