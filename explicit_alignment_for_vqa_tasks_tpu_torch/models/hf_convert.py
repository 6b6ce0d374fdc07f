"""HuggingFace T5, CLIP and GPT-2 checkpoints, and the reference's
trained mappers -> the port's parameter trees (numpy).

Counterpart of explicit_alignment_for_vqa_tasks_tpu/models/hf_convert.py:
pure numpy on a state dict, so ``transformers`` is not imported here. The trees
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


def mapper_params_from_reference_ckpt(state_dict: Mapping[str, Any],
                                      mapping_type: str,
                                      dtype: Any = np.float32) -> Params:
    """Convert a reference (PyTorch-Lightning) checkpoint's trained
    mapping-network weights to the mapper tree (models/mappers.py; the JAX
    package's :238-308).

    The reference checkpoint stores the full LightningModule state dict
    with a ``model.`` prefix (its caption notebook strips ``key[6:]``);
    only ``clip_project.*`` is trainable, so that is all that is converted.
    Layouts (reference: src/models/vct0.py):
      * MLP: ``clip_project.model.{0,2}.{weight,bias}`` — torch Linear
        (out, in), transposed to (in, out)
      * Transformer: ``clip_project.linear``, ``clip_project.prefix_const``
        and 8 ``clip_project.transformer.layers.{i}`` blocks
        (attn.to_queries / to_keys_values / project, mlp.fc1/fc2,
        norm1/norm2), stacked on a leading layer axis
    """
    sd = {}
    for key, value in state_dict.items():
        key = key.removeprefix("model.")
        if key.startswith("clip_project."):
            sd[key.removeprefix("clip_project.")] = value
    if not sd:
        raise ValueError("no clip_project.* weights found in checkpoint")

    def linear(prefix: str, bias_optional: bool = False) -> Params:
        out: Params = {"w": _np(sd[f"{prefix}.weight"], dtype).T}
        if f"{prefix}.bias" in sd:
            out["b"] = _np(sd[f"{prefix}.bias"], dtype)
        elif bias_optional:
            out["b"] = np.zeros(out["w"].shape[-1], dtype=dtype)
        else:
            raise KeyError(f"{prefix}.bias")
        return out

    if mapping_type == "mlp":
        return {"fc1": linear("model.0"), "fc2": linear("model.2")}

    if mapping_type == "transformer":
        n_layers = 0
        while f"transformer.layers.{n_layers}.norm1.weight" in sd:
            n_layers += 1
        blocks = []
        for i in range(n_layers):
            base = f"transformer.layers.{i}"
            blocks.append({
                "ln1_scale": _np(sd[f"{base}.norm1.weight"], dtype),
                "ln1_bias": _np(sd[f"{base}.norm1.bias"], dtype),
                "q": linear(f"{base}.attn.to_queries", bias_optional=True),
                "kv": linear(f"{base}.attn.to_keys_values",
                             bias_optional=True),
                "o": linear(f"{base}.attn.project"),
                "ln2_scale": _np(sd[f"{base}.norm2.weight"], dtype),
                "ln2_bias": _np(sd[f"{base}.norm2.bias"], dtype),
                "mlp": {
                    "fc1": linear(f"{base}.mlp.fc1"),
                    "fc2": linear(f"{base}.mlp.fc2"),
                },
            })
        return {
            "linear": linear("linear"),
            "prefix_const": _np(sd["prefix_const"], dtype),
            "blocks": _stack_trees(blocks),
        }

    raise ValueError(
        f"unsupported mapping_type for conversion: {mapping_type}"
    )


def _stack_trees(trees: list) -> Params:
    """Nested dicts of equal structure, their leaves stacked on a new
    leading axis (``jax.tree.map(np.stack)`` of the JAX package)."""
    return {k: _stack_trees([t[k] for t in trees])
            if isinstance(trees[0][k], dict)
            else np.stack([t[k] for t in trees]) for k in trees[0]}
