"""Convert the JAX package's Orbax checkpoints into checkpoints of the port.

The JAX package saves the trainable state (``{"mapper", "opt_state",
"epoch"}``) with ``orbax.checkpoint.PyTreeCheckpointer``
(explicit_alignment_for_vqa_tasks_tpu/trainers/checkpointing.py); the port
saves torch files (trainers/checkpointing.py). Orbax imports jax, which the
port does not, so this tool reads the checkpoint with ``tensorstore``
alone: ``_METADATA``'s ``tree_metadata`` gives the tree (each leaf's key
path), and each array is a zarr array under its dotted key path, in an
OCDBT key-value store (orbax 0.11's default) or as plain files.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.\
convert_orbax_checkpoint --src .../jax_run/saved_model \
        --out .../port_run/saved_model

``--src`` is a JAX ``saved_model`` directory (every ``model_NN`` its
``checkpoint_index.json`` lists is converted and the index copied) or one
checkpoint directory of it (converted to ``<out>/<its name>``, a
``model_NN`` recorded in ``<out>``'s index). Each becomes
``trainable_state.pt`` holding:

  * ``mapper``: the mapper tree, fp32 tensors, bit for bit;
  * ``epoch``, where the checkpoint has one;
  * ``opt_state``, where it has one: the optax state (``adamw``, behind
    ``clip_by_global_norm`` when clipping, inside ``optax.MultiSteps``
    when accumulating) as ``MultiStepAdamW.state_dict()``
    (trainers/optimization.py): ``mu`` and ``nu`` from
    ``ScaleByAdamState``, ``acc`` from ``MultiStepsState.acc_grads`` (None
    without MultiSteps), ``mini_step`` from it (0 without), ``applied``
    from the Adam ``count``; each list in ``tree_leaves`` order of the
    mapper. A run resumed from it goes on as the JAX run would.

``tensorstore`` is imported inside ``read_orbax_tree`` only; where it is
missing, convert on a host that has it and copy the torch files.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..trainers.optimization import tree_leaves
from .convert_reference_checkpoint import write_port_checkpoint

logger = logging.getLogger(__name__)

METADATA_FILE = "_METADATA"
INDEX_FILE = "checkpoint_index.json"


def _tensorstore():
    try:
        import tensorstore
    except ImportError as exc:
        raise ImportError(
            "converting an Orbax checkpoint needs the tensorstore package; "
            "run this tool on a host that has it") from exc
    return tensorstore


def read_orbax_tree(path: str) -> Dict[str, Any]:
    """The tree of the Orbax checkpoint at ``path`` as nested dicts (tuple
    and list positions as the keys "0", "1", ...): arrays as numpy, scalars
    as Python numbers, empty nodes (``None``, ``EmptyState``) as None."""
    ts = _tensorstore()
    path = os.path.abspath(path)
    with open(os.path.join(path, METADATA_FILE), encoding="utf-8") as fh:
        leaves = json.load(fh)["tree_metadata"]
    if os.path.exists(os.path.join(path, "manifest.ocdbt")):
        kvstore = {"driver": "ocdbt", "base": f"file://{path}/"}
    else:
        kvstore = {"driver": "file", "path": f"{path}/"}
    stored = {key.decode() for key in
              ts.KvStore.open(kvstore).result().list().result()}
    tree: Dict[str, Any] = {}
    for entry in leaves.values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        meta = entry["value_metadata"]
        value = None
        if meta["value_type"] != "None" and not meta.get("skip_deserialize"):
            name = ".".join(keys)
            driver = "zarr3" if f"{name}/zarr.json" in stored else "zarr"
            array = ts.open({"driver": driver, "kvstore": dict(
                kvstore, path=kvstore.get("path", "") + name + "/")}
            ).result().read().result()
            value = np.asarray(array)
            if meta["value_type"] == "scalar":
                value = value.item()
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return tree


def _leaves(tree: Dict[str, Any]) -> List[torch.Tensor]:
    """The arrays of a mapper-shaped tree as tensors, in the port's
    ``tree_leaves`` order (sorted keys)."""
    return tree_leaves(_to_torch(tree))


def _to_torch(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _find(tree: Any, keys: set) -> List[Dict[str, Any]]:
    """The nodes of ``tree`` that hold every key of ``keys``."""
    if not isinstance(tree, dict):
        return []
    if keys <= set(tree):
        return [tree]
    return [node for value in tree.values() for node in _find(value, keys)]


def _one(tree: Any, keys: set, what: str) -> Optional[Dict[str, Any]]:
    nodes = _find(tree, keys)
    if len(nodes) > 1:
        raise ValueError(f"opt_state holds {len(nodes)} {what} states; the "
                         "port's MultiStepAdamW has one")
    return nodes[0] if nodes else None


def optimizer_state(opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's optax state as ``MultiStepAdamW.state_dict()``."""
    adam = _one(opt_state, {"count", "mu", "nu"}, "Adam")
    if adam is None:
        raise ValueError("opt_state holds no ScaleByAdamState (count, mu, "
                         "nu): not the JAX package's adamw chain")
    multi = _one(opt_state, {"mini_step", "acc_grads", "inner_opt_state"},
                 "MultiSteps")
    return {
        "mu": _leaves(adam["mu"]),
        "nu": _leaves(adam["nu"]),
        "acc": None if multi is None else _leaves(multi["acc_grads"]),
        "mini_step": 0 if multi is None else int(multi["mini_step"]),
        "applied": int(adam["count"]),
    }


def port_state(tree: Dict[str, Any]) -> Dict[str, Any]:
    """An Orbax tree of the JAX package's trainable state as the port's."""
    if "mapper" not in tree:
        raise ValueError("the checkpoint holds no mapper")
    state: Dict[str, Any] = {"mapper": _to_torch(tree["mapper"])}
    if tree.get("epoch") is not None:
        state["epoch"] = int(tree["epoch"])
    if tree.get("opt_state") is not None:
        state["opt_state"] = optimizer_state(tree["opt_state"])
    return state


def convert_one(src: str, out: str) -> str:
    """The Orbax checkpoint directory ``src`` as the port's checkpoint
    ``out`` (a directory; a ``model_NN`` is recorded in its parent's
    index). Returns ``out``'s absolute path."""
    path = write_port_checkpoint(out, port_state(read_orbax_tree(src)))
    logger.info("converted %s -> %s", src, path)
    return path


def convert(src: str, out: str) -> List[str]:
    """Convert ``src`` (a JAX ``saved_model`` directory, or one checkpoint
    directory of it) into the port's ``saved_model`` directory ``out``.
    Returns the converted checkpoints' paths."""
    src = os.path.abspath(src)
    if os.path.exists(os.path.join(src, METADATA_FILE)):
        return [convert_one(src, os.path.join(out, os.path.basename(src)))]
    index_path = os.path.join(src, INDEX_FILE)
    if not os.path.exists(index_path):
        raise FileNotFoundError(
            f"{src} is neither an Orbax checkpoint ({METADATA_FILE}) nor a "
            f"saved_model directory ({INDEX_FILE})")
    with open(index_path, encoding="utf-8") as fh:
        index = json.load(fh)
    paths = [convert_one(os.path.join(src, name), os.path.join(out, name))
             for name in index["epochs"]]
    with open(os.path.join(out, INDEX_FILE), "w", encoding="utf-8") as fh:
        json.dump(index, fh, indent=2)
    return paths


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True,
                        help="the JAX package's saved_model directory, or "
                             "one model_NN of it")
    parser.add_argument("--out", required=True,
                        help="the port's saved_model directory")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    convert(args.src, args.out)


if __name__ == "__main__":
    main()
