"""ClipCap's executor (``configs/vqa2/clip_cap.jsonnet``'s ``train.type``).

Its counterpart, explicit_alignment_for_vqa_tasks_tpu/trainers/
clipcap_executor.py, trains and evaluates ClipCap through ``main``; it is
not ported yet (ROADMAP.md, Queue 1 item 11). The name is registered so
that a run of that config says so. ClipCap itself runs in the port:
``models/clipcap.py`` (generate, ``clipcap_loss`` and its backward through
``fused_gpt2_block_vjp``) and ``tools/bench_train.py --model clipcap``.
"""

from __future__ import annotations

from typing import Any

from ..device import DeviceLike
from ..registry import EXECUTORS


@EXECUTORS.register()
class ClipCapExecutor:
    def __init__(self, config: Any, data_loader: Any,
                 device: DeviceLike = None):
        raise NotImplementedError(
            "ClipCapExecutor is not ported yet (ROADMAP.md, Queue 1 item "
            "11): ClipCap's loss and its gradient run through "
            "models.clipcap and tools.bench_train --model clipcap")
