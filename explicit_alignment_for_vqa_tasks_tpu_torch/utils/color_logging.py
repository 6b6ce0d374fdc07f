"""ANSI-colored console log formatter (reference: src/utils/color_logging.py:4-26).

The port's own copy of
explicit_alignment_for_vqa_tasks_tpu/utils/color_logging.py, held against it by
tests/test_torch_config.py.
"""

from __future__ import annotations

import logging

_RESET = "\x1b[0m"
_COLORS = {
    logging.DEBUG: "\x1b[36m",     # cyan
    logging.INFO: "\x1b[32m",      # green
    logging.WARNING: "\x1b[33m",   # yellow
    logging.ERROR: "\x1b[31m",     # red
    logging.CRITICAL: "\x1b[41m",  # red background
}


class ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        color = _COLORS.get(record.levelno, "")
        return f"{color}{msg}{_RESET}" if color else msg


def setup_console_logging(level: int = logging.INFO) -> None:
    handler = logging.StreamHandler()
    handler.setFormatter(
        ColorFormatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    root = logging.getLogger()
    root.setLevel(level)
    # replace any prior console handlers to avoid duplicate lines
    root.handlers = [
        h for h in root.handlers if not isinstance(h, logging.StreamHandler)
    ]
    root.addHandler(handler)
