"""HuggingFace T5, CLIP and GPT-2 checkpoints -> the port's parameter
trees (numpy).

Counterpart of the T5, CLIP and GPT-2 converters of
explicit_alignment_for_vqa_tasks_tpu/models/hf_convert.py (:33-235): pure
numpy on a state dict, so ``transformers`` is not imported here. The trees
are the JAX package's (keys, stacked layer axis, (in, out) weights, HWIO
patch kernel); ``convert.t5_params_from_numpy``,
``clip_vision_params_from_numpy``, ``clip_text_params_from_numpy`` and
``gpt2_params_from_numpy`` carry them to torch tensors.
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


def t5_params_from_hf(state_dict: Mapping[str, Any], cfg,
                      dtype: Any = np.float32) -> Params:
    """A HF ``T5ForConditionalGeneration`` state dict (T5 v1.1 layout) as
    the stacked T5 tree of ``models/t5.py``: attention and FFN weights
    transposed to (in, out) and stacked on a leading layer axis, the
    relative-position biases of block 0, the untied LM head transposed."""
    sd = state_dict
    ne, nd = cfg.num_encoder_layers, cfg.num_decoder_layers

    def block(prefix: str, n: int, layer_idx: int, name: str,
              transpose: bool = True) -> np.ndarray:
        return _stack(sd, prefix + ".block.{}" + f".layer.{layer_idx}.{name}",
                      n, transpose=transpose, dtype=dtype)

    def attn(prefix: str, n: int, layer_idx: int) -> Params:
        kind = "SelfAttention" if layer_idx == 0 else "EncDecAttention"
        return {name: block(prefix, n, layer_idx, f"{kind}.{name}.weight")
                for name in ("q", "k", "v", "o")}

    def ffn(prefix: str, n: int, layer_idx: int) -> Params:
        names = ("wi_0", "wo", "wi_1") if cfg.is_gated_act else ("wi_0", "wo")
        return {name: block(prefix, n, layer_idx,
                            f"DenseReluDense.{name}.weight")
                for name in names}

    def lns(prefix: str, n: int, count: int) -> Params:
        return {f"ln{i}": block(prefix, n, i, "layer_norm.weight", False)
                for i in range(count)}

    def rel_bias(prefix: str) -> np.ndarray:
        return _np(sd[prefix + ".block.0.layer.0.SelfAttention."
                      "relative_attention_bias.weight"], dtype)

    params: Params = {
        "shared": _np(sd["shared.weight"], dtype),
        "encoder": {
            "self_attn": attn("encoder", ne, 0),
            "ffn": ffn("encoder", ne, 1),
            **lns("encoder", ne, 2),
            "rel_bias": rel_bias("encoder"),
            "final_ln": _np(sd["encoder.final_layer_norm.weight"], dtype),
        },
        "decoder": {
            "self_attn": attn("decoder", nd, 0),
            "cross_attn": attn("decoder", nd, 1),
            "ffn": ffn("decoder", nd, 2),
            **lns("decoder", nd, 3),
            "rel_bias": rel_bias("decoder"),
            "final_ln": _np(sd["decoder.final_layer_norm.weight"], dtype),
        },
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _np(sd["lm_head.weight"], dtype).T
    return params


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
