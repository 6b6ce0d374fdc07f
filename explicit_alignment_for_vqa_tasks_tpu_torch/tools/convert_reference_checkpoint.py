"""Convert a reference (torch/PL) mapper checkpoint to a checkpoint of the
port.

Counterpart of
explicit_alignment_for_vqa_tasks_tpu/tools/convert_reference_checkpoint.py.
The reference's checkpoints are full LightningModule state dicts; only the
mapping network (``model.clip_project.*``) is trainable (reference:
src/models/vct0.py:535-544), so that is the payload converted here: into
``<out>/trainable_state.pt`` holding ``{"mapper": ...}`` (fp32 tensors),
which ``trainers.checkpointing.load_checkpoint`` reads. Where ``out`` is
named ``model_NN``, it is also recorded as epoch NN in its parent's
``checkpoint_index.json``, so that ``main --mode test`` with
``saved_model_path`` the parent finds it; under any other name pass it as
``test.load_model_path``. Host code only.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.\
convert_reference_checkpoint \
        --ckpt .../model_04.ckpt --mapping_type mlp \
        --out .../saved_model/model_04
"""

from __future__ import annotations

import argparse
import logging
import os
import re

import torch

from ..convert import _tree_to_torch
from ..models.hf_convert import mapper_params_from_reference_ckpt
from ..trainers.checkpointing import record_checkpoint, write_state

logger = logging.getLogger(__name__)

EPOCH_DIR = re.compile(r"model_(\d+)")


def write_port_checkpoint(out_path: str, state: dict) -> str:
    """``state`` as ``out_path``'s ``trainable_state.pt``; a ``model_NN``
    directory is also recorded in its parent's index. Returns the path."""
    out_path = os.path.abspath(out_path)
    write_state(out_path, state)
    name = os.path.basename(out_path)
    if EPOCH_DIR.fullmatch(name):
        record_checkpoint(os.path.dirname(out_path), name)
    return out_path


def convert(ckpt_path: str, mapping_type: str, out_path: str) -> str:
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state_dict = payload.get("state_dict", payload)
    mapper = mapper_params_from_reference_ckpt(state_dict, mapping_type)
    out = write_port_checkpoint(out_path, {
        "mapper": _tree_to_torch(mapper, torch.float32, torch.device("cpu"))})
    logger.info("converted %s -> %s", ckpt_path, out)
    return out


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--mapping_type", default="mlp",
                        choices=["mlp", "transformer"])
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    convert(args.ckpt, args.mapping_type, args.out)


if __name__ == "__main__":
    main()
