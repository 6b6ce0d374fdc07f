"""Carry the JAX package's parameter trees across to the port.

The trees keep their keys and the stacked layer axis, so the same weights
run through both packages. Leaves arrive as numpy arrays
(``np.asarray`` of each JAX leaf). numpy's bfloat16 (from ``ml_dtypes``) is
refused by ``torch.from_numpy``, so every float leaf goes through float32,
which holds any bf16 value exactly. Integer leaves (the int8 weight codes)
keep their type. Two rules keep the int8 dequant scales float32 whatever
the tree's dtype, since rounding them would change every product:

  * leaves named ``*_s`` (the T5 int8 trees);
  * every float leaf under a ``blocks_q8`` subtree (the CLIP tree of
    ``models.clip.quantize_vision_blocks``, whose scales are named
    ``*_scale``). The rule cannot be "ends in ``_scale``": the LayerNorm
    scales (``ln1_scale``, ``pre_ln_scale``, ...) are bf16 parameters.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device

Params = Dict[str, Any]


def _tree_to_torch(tree: Any, dtype: torch.dtype, device: torch.device,
                   name: str = "", in_q8: bool = False) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, dtype, device, k,
                                  in_q8 or k == "blocks_q8")
                for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind in "iub":
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    arr32 = np.ascontiguousarray(arr.astype(np.float32))
    leaf_dtype = torch.float32 if in_q8 or name.endswith("_s") else dtype
    return torch.from_numpy(arr32).to(device=device, dtype=leaf_dtype)


def t5_params_from_numpy(tree: Params, dtype: torch.dtype = torch.bfloat16,
                         device: DeviceLike = None) -> Params:
    """The JAX ``init_t5_params`` tree (numpy leaves) as port params, float
    leaves in ``dtype`` on ``device`` (the card by default)."""
    return _tree_to_torch(tree, dtype, resolve_device(device))


def vct0_params_from_numpy(tree: Params, lm_dtype: torch.dtype = torch.bfloat16,
                           device: DeviceLike = None) -> Params:
    """The JAX ``{"lm", "mapper"}`` tree as port params: the LM in
    ``lm_dtype``, the mapper in fp32 (the mapper runs in fp32)."""
    dev = resolve_device(device)
    return {
        "lm": _tree_to_torch(tree["lm"], lm_dtype, dev),
        "mapper": _tree_to_torch(tree["mapper"], torch.float32, dev),
    }


def clip_vision_params_from_numpy(tree: Params,
                                  dtype: torch.dtype = torch.bfloat16,
                                  device: DeviceLike = None) -> Params:
    """The JAX ``init_clip_vision_params`` (or ``clip_vision_params_from_hf``)
    tree as port params: same keys and stacked layer axis, float leaves in
    ``dtype`` on ``device`` (the card by default)."""
    return _tree_to_torch(tree, dtype, resolve_device(device))


def clip_text_params_from_numpy(tree: Params,
                                dtype: torch.dtype = torch.bfloat16,
                                device: DeviceLike = None) -> Params:
    """The JAX CLIP text tree as port params (see
    ``clip_vision_params_from_numpy``)."""
    return _tree_to_torch(tree, dtype, resolve_device(device))


def gpt2_params_from_numpy(tree: Params, dtype: torch.dtype = torch.bfloat16,
                           device: DeviceLike = None) -> Params:
    """The JAX ``init_gpt2_params`` (or ``gpt2_params_from_hf``) tree as
    port params: same keys and stacked layer axis, float leaves in ``dtype``
    on ``device`` (the card by default)."""
    return _tree_to_torch(tree, dtype, resolve_device(device))


def clipcap_params_from_numpy(tree: Params,
                              lm_dtype: torch.dtype = torch.bfloat16,
                              device: DeviceLike = None) -> Params:
    """The JAX ClipCap ``{"lm", "mapper"}`` tree as port params: the GPT-2
    LM in ``lm_dtype``, the mapper in fp32 (the mapper runs in fp32)."""
    dev = resolve_device(device)
    return {
        "lm": _tree_to_torch(tree["lm"], lm_dtype, dev),
        "mapper": _tree_to_torch(tree["mapper"], torch.float32, dev),
    }
