"""Checkpointing of the trainable state as torch files.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/trainers/checkpointing.py.
Only the mapper trains (reference: vct0.py:535-544), so the payload is the
trainable state tree (the mapper's tensors; in a train run also the
optimizer's ``state_dict()``, under ``opt_state``) plus ``epoch``; a run
resumed from it goes on as the uninterrupted run would. The JAX
package saves it with Orbax, which the port does not use: each checkpoint
is a directory ``model_{epoch:02d}`` holding ``trainable_state.pt``
(``torch.save`` of the tree, tensors on the CPU). The index
``checkpoint_index.json``, the best/last aliases and the resolution order
of ``get_checkpoint_model_path`` are the JAX package's. An Orbax
directory is refused; ``tools/convert_orbax_checkpoint.py`` converts one
(and ``tools/convert_reference_checkpoint.py`` a reference checkpoint) into
this layout.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

import torch

from ..device import rank

logger = logging.getLogger(__name__)

_META_FILE = "checkpoint_index.json"
STATE_FILE = "trainable_state.pt"


def _index_path(saved_model_path: str) -> str:
    return os.path.join(saved_model_path, _META_FILE)


def _load_index(saved_model_path: str) -> Dict[str, Any]:
    path = _index_path(saved_model_path)
    if os.path.exists(path):
        with open(path, "r", encoding="utf-8") as fh:
            return json.load(fh)
    return {"epochs": [], "best": None, "best_metric": None, "last": None}


def _save_index(saved_model_path: str, index: Dict[str, Any]) -> None:
    os.makedirs(saved_model_path, exist_ok=True)
    with open(_index_path(saved_model_path), "w", encoding="utf-8") as fh:
        json.dump(index, fh, indent=2)


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(
    saved_model_path: str,
    epoch: int,
    state: Dict[str, Any],
    metric_value: Optional[float] = None,
    metric_mode: str = "min",
) -> str:
    """Save ``model_{epoch:02d}`` and update last/best aliases. ``state``
    is a tree of tensors and Python numbers; ``epoch`` is stored in it.
    Over several processes rank 0 alone writes (JAX
    ``checkpointing.py:63``); every rank gets the path."""
    name = f"model_{epoch:02d}"
    path = os.path.abspath(os.path.join(saved_model_path, name))
    if rank() != 0:
        return path
    payload = dict(state)
    payload["epoch"] = int(epoch)
    write_state(path, payload)
    record_checkpoint(saved_model_path, name, metric_value, metric_mode)
    logger.info("saved checkpoint %s", path)
    return path


def write_state(path: str, payload: Dict[str, Any]) -> None:
    """``payload`` (tensors moved to the CPU) as ``path``'s
    ``trainable_state.pt``, written whole or not at all."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_to_cpu(payload), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def record_checkpoint(saved_model_path: str, name: str,
                      metric_value: Optional[float] = None,
                      metric_mode: str = "min") -> None:
    """Add ``name`` to the index of ``saved_model_path`` as the last
    checkpoint, and as the best where ``metric_value`` beats the best's."""
    index = _load_index(saved_model_path)
    if name not in index["epochs"]:
        index["epochs"].append(name)
    index["last"] = name
    if metric_value is not None:
        best = index.get("best_metric")
        better = (
            best is None
            or (metric_mode == "min" and metric_value < best)
            or (metric_mode == "max" and metric_value > best)
        )
        if better:
            index["best"] = name
            index["best_metric"] = float(metric_value)
    _save_index(saved_model_path, index)


def get_checkpoint_model_path(
    saved_model_path: str,
    load_epoch: int = -1,
    load_best_model: bool = False,
    load_model_path: str = "",
) -> Optional[str]:
    """Resolve which checkpoint to load (reference: src/main.py:35-66):
    explicit path > best > specific epoch > last. Returns None when nothing
    exists (\"first time to train\")."""
    if load_model_path:
        return load_model_path
    index = _load_index(saved_model_path)
    name: Optional[str] = None
    if load_best_model and index.get("best"):
        name = index["best"]
    elif load_epoch is not None and load_epoch >= 0:
        candidate = f"model_{load_epoch:02d}"
        if candidate in index["epochs"]:
            name = candidate
    elif index.get("last"):
        name = index["last"]
    if name is None:
        return None
    path = os.path.abspath(os.path.join(saved_model_path, name))
    return path if os.path.exists(path) else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The state tree saved at ``path`` (a ``model_NN`` directory or its
    ``trainable_state.pt``), tensors on the CPU."""
    path = os.path.abspath(path)
    file = os.path.join(path, STATE_FILE) if os.path.isdir(path) else path
    if not os.path.isfile(file):
        raise ValueError(
            f"{path} holds no {STATE_FILE}: an Orbax checkpoint of the JAX "
            "package is not read here; convert it on a host with "
            "tensorstore: python -m explicit_alignment_for_vqa_tasks_tpu_"
            "torch.tools.convert_orbax_checkpoint --src <its saved_model "
            "dir or model_NN> --out <the port's saved_model dir>")
    return torch.load(file, map_location="cpu", weights_only=True)
