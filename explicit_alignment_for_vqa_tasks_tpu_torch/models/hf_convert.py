"""HuggingFace CLIP and GPT-2 checkpoints -> the port's parameter trees
(numpy).

Counterpart of the CLIP and GPT-2 converters of
explicit_alignment_for_vqa_tasks_tpu/models/hf_convert.py (:111-235): pure
numpy on a state dict, so ``transformers`` is not imported here. The trees
are the JAX package's (keys, stacked layer axis, (in, out) weights, HWIO
patch kernel); ``convert.clip_vision_params_from_numpy``,
``clip_text_params_from_numpy`` and ``gpt2_params_from_numpy`` carry them
to torch tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

Params = Dict[str, Any]

# (ours, HF name template, transpose) of one CLIP encoder layer
_BLOCK_KEYS = [
    ("ln1_scale", "encoder.layers.{}.layer_norm1.weight", False),
    ("ln1_bias", "encoder.layers.{}.layer_norm1.bias", False),
    ("q", "encoder.layers.{}.self_attn.q_proj.weight", True),
    ("q_bias", "encoder.layers.{}.self_attn.q_proj.bias", False),
    ("k", "encoder.layers.{}.self_attn.k_proj.weight", True),
    ("k_bias", "encoder.layers.{}.self_attn.k_proj.bias", False),
    ("v", "encoder.layers.{}.self_attn.v_proj.weight", True),
    ("v_bias", "encoder.layers.{}.self_attn.v_proj.bias", False),
    ("o", "encoder.layers.{}.self_attn.out_proj.weight", True),
    ("o_bias", "encoder.layers.{}.self_attn.out_proj.bias", False),
    ("ln2_scale", "encoder.layers.{}.layer_norm2.weight", False),
    ("ln2_bias", "encoder.layers.{}.layer_norm2.bias", False),
    ("mlp_fc", "encoder.layers.{}.mlp.fc1.weight", True),
    ("mlp_fc_bias", "encoder.layers.{}.mlp.fc1.bias", False),
    ("mlp_proj", "encoder.layers.{}.mlp.fc2.weight", True),
    ("mlp_proj_bias", "encoder.layers.{}.mlp.fc2.bias", False),
]


def _np(tensor: Any, dtype: Any = np.float32) -> np.ndarray:
    if hasattr(tensor, "detach"):
        tensor = tensor.detach().cpu().float().numpy()
    return np.asarray(tensor, dtype=dtype)


def _stack(sd: Mapping[str, Any], template: str, n_layers: int,
           transpose: bool = False, dtype: Any = np.float32) -> np.ndarray:
    arrays = []
    for i in range(n_layers):
        arr = _np(sd[template.format(i)], dtype)
        arrays.append(arr.T if transpose else arr)
    return np.stack(arrays)


def _blocks(sd: Mapping[str, Any], n_layers: int, dtype: Any) -> Params:
    return {ours: _stack(sd, theirs, n_layers, transpose=transpose,
                         dtype=dtype)
            for ours, theirs, transpose in _BLOCK_KEYS}


def clip_vision_params_from_hf(state_dict: Mapping[str, Any], cfg,
                               dtype: Any = np.float32) -> Params:
    """Convert a HF CLIPVisionModelWithProjection (or the vision tower of
    CLIPModel) state_dict to the vision tree (see models/clip.py)."""
    sd = {k.removeprefix("vision_model."): v for k, v in state_dict.items()}
    params: Params = {
        "class_embedding": _np(sd["embeddings.class_embedding"], dtype),
        "patch_embedding": np.transpose(
            _np(sd["embeddings.patch_embedding.weight"], dtype), (2, 3, 1, 0)
        ),  # torch OIHW -> HWIO
        "position_embedding": _np(
            sd["embeddings.position_embedding.weight"], dtype),
        "pre_ln_scale": _np(sd["pre_layrnorm.weight"], dtype),
        "pre_ln_bias": _np(sd["pre_layrnorm.bias"], dtype),
        "blocks": _blocks(sd, cfg.num_layers, dtype),
        "post_ln_scale": _np(sd["post_layernorm.weight"], dtype),
        "post_ln_bias": _np(sd["post_layernorm.bias"], dtype),
    }
    if "visual_projection.weight" in state_dict:
        params["projection"] = _np(
            state_dict["visual_projection.weight"], dtype).T
    return params


def clip_text_params_from_hf(state_dict: Mapping[str, Any], cfg,
                             dtype: Any = np.float32) -> Params:
    """Convert a HF CLIPTextModelWithProjection (or the text tower of
    CLIPModel) state_dict to the text tree (see models/clip.py)."""
    sd = {k.removeprefix("text_model."): v for k, v in state_dict.items()}
    params: Params = {
        "token_embedding": _np(sd["embeddings.token_embedding.weight"], dtype),
        "position_embedding": _np(
            sd["embeddings.position_embedding.weight"], dtype),
        "blocks": _blocks(sd, cfg.num_layers, dtype),
        "final_ln_scale": _np(sd["final_layer_norm.weight"], dtype),
        "final_ln_bias": _np(sd["final_layer_norm.bias"], dtype),
    }
    if "text_projection.weight" in state_dict:
        params["projection"] = _np(
            state_dict["text_projection.weight"], dtype).T
    return params


# (ours, HF name template) of one GPT-2 layer; HF's Conv1D stores its
# weights as (in, out), the orientation of the JAX tree
_GPT2_BLOCK_KEYS = [
    ("ln1_scale", "h.{}.ln_1.weight"), ("ln1_bias", "h.{}.ln_1.bias"),
    ("attn_qkv", "h.{}.attn.c_attn.weight"),
    ("attn_qkv_bias", "h.{}.attn.c_attn.bias"),
    ("attn_out", "h.{}.attn.c_proj.weight"),
    ("attn_out_bias", "h.{}.attn.c_proj.bias"),
    ("ln2_scale", "h.{}.ln_2.weight"), ("ln2_bias", "h.{}.ln_2.bias"),
    ("mlp_fc", "h.{}.mlp.c_fc.weight"), ("mlp_fc_bias", "h.{}.mlp.c_fc.bias"),
    ("mlp_proj", "h.{}.mlp.c_proj.weight"),
    ("mlp_proj_bias", "h.{}.mlp.c_proj.bias"),
]


def gpt2_params_from_hf(state_dict: Mapping[str, Any], cfg,
                        dtype: Any = np.float32) -> Params:
    """Convert a HF GPT2LMHeadModel (or GPT2Model) state_dict to the GPT-2
    tree (see models/gpt2.py); no weight is transposed."""
    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}
    return {
        "wte": _np(sd["wte.weight"], dtype),
        "wpe": _np(sd["wpe.weight"], dtype),
        "blocks": {ours: _stack(sd, theirs, cfg.num_layers, dtype=dtype)
                   for ours, theirs in _GPT2_BLOCK_KEYS},
        "ln_f_scale": _np(sd["ln_f.weight"], dtype),
        "ln_f_bias": _np(sd["ln_f.bias"], dtype),
    }
