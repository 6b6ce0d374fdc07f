"""Build models from the config-file schema.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/trainers/model_factory.py.
The LM architecture comes from ``model_config.ConfigClass``, the serving
options from the config's ``tpu`` block (``compute_dtype``,
``params_dtype``, ``fused_attention``, ``fused_ffn``, the int8 opt-ins),
with ``model_config.lm_config`` winning over them, exactly as in the JAX
package. Pretrained HF weights are converted when ``transformers`` and a
local copy of the checkpoint are present; otherwise the params are random
from ``config.seed``, with a logged warning (no download is attempted).

The model's params live on ``device``: the CUDA card unless the caller
passes another (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import torch

from ..convert import gpt2_params_from_numpy, t5_params_from_numpy
from ..device import DeviceLike, resolve_device
from ..models.clipcap import ClipCapConfig, ClipCaptionModel, init_clipcap_params
from ..models.gpt2 import GPT2Config
from ..models.hf_convert import gpt2_params_from_hf, t5_params_from_hf
from ..models.t5 import T5Config
from ..models.vct0 import (
    VCT0Config,
    VCT0Model,
    init_vct0_params,
    quantize_int8_encoder,
)

logger = logging.getLogger(__name__)

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}

# ConfigClass string -> base LM config factory
T5_CONFIGS = {
    "T0_3B": T5Config.t0_3b,
    "T0": T5Config.t0_3b,
    "T5_test": T5Config.small_test,
}
GPT2_CONFIGS = {
    "GPT2": GPT2Config.gpt2_small,
    "GPT2_test": GPT2Config.small_test,
}


def _compute_dtype(config: Any) -> torch.dtype:
    name = config.get("tpu", {}).get("compute_dtype", "bfloat16")
    return _DTYPES[name]


def _param_dtype(config: Any) -> torch.dtype:
    name = config.get("tpu", {}).get("params_dtype", "bfloat16")
    return _DTYPES[name]


def _lm_overrides(config: Any) -> Dict[str, Any]:
    """Optional dims override block (used by tests / small dev runs)."""
    return dict(config.model_config.get("lm_config", {}))


def _try_load_hf_t5(model_version: str, cfg: T5Config,
                    param_dtype: torch.dtype,
                    device: torch.device) -> Optional[Dict]:
    try:
        import transformers

        model = transformers.T5ForConditionalGeneration.from_pretrained(
            model_version, local_files_only=True, torch_dtype="float32"
        )
        params = t5_params_from_hf(model.state_dict(), cfg)
        del model
        return t5_params_from_numpy(params, param_dtype, device)
    except Exception as exc:
        logger.warning(
            "could not load pretrained T5 weights %r locally (%s); using "
            "random init", model_version, exc,
        )
        return None


def _try_load_hf_gpt2(model_version: str, cfg: GPT2Config,
                      param_dtype: torch.dtype,
                      device: torch.device) -> Optional[Dict]:
    try:
        import transformers

        model = transformers.GPT2LMHeadModel.from_pretrained(
            model_version, local_files_only=True
        )
        params = gpt2_params_from_hf(model.state_dict(), cfg)
        del model
        return gpt2_params_from_numpy(params, param_dtype, device)
    except Exception as exc:
        logger.warning(
            "could not load pretrained GPT-2 weights %r locally (%s); using "
            "random init", model_version, exc,
        )
        return None


def _vct0_overrides(config: Any) -> Dict[str, Any]:
    """``lm_config``, then each ``tpu`` knob where ``lm_config`` does not
    name it (JAX ``model_factory.py:115-164``)."""
    tpu = config.get("tpu", {})
    overrides = _lm_overrides(config)
    for field, knob in (("remat", "remat"),
                        ("fused_encoder_attention", "fused_attention"),
                        ("fused_encoder_ffn", "fused_ffn"),
                        ("int8_cross_kv", "int8_cross_kv")):
        overrides.setdefault(field, bool(tpu.get(knob, False)))
    # tpu.int8_kv_layout: cross-KV cache storage layout override
    # (unmerged | merged | transposed; unset = auto by decode batch)
    if "int8_kv_layout" in tpu:
        overrides.setdefault("int8_kv_layout", str(tpu["int8_kv_layout"]))
    for field in ("int8_encoder_ffn", "int8_encoder_attn",
                  "int8_decoder_step"):
        overrides.setdefault(field, bool(tpu.get(field, False)))
    return overrides


def build_model_from_config(config: Any,
                            device: DeviceLike = None) -> Tuple[Any, str]:
    """Returns (model, model_kind) where model_kind is 'vct0'/'clipcap'.
    The params are drawn (or loaded) on ``device``, the card by default."""
    dev = resolve_device(device)
    mc = config.model_config
    model_class = mc.ModelClass
    model_args = dict(mc.get("model_args", {}))
    compute_dtype = _compute_dtype(config)
    param_dtype = _param_dtype(config)
    seed = int(config.get("seed", 0))
    tpu = config.get("tpu", {})

    if model_class in ("VCT0Prefix", "VCT0Model"):
        base = T5_CONFIGS.get(mc.get("ConfigClass", "T0_3B"), T5Config.t0_3b)
        lm_cfg = base(dtype=compute_dtype, **_vct0_overrides(config))
        cfg = VCT0Config.from_model_args(
            model_args, lm_cfg=lm_cfg,
            freeze_lm=(model_class == "VCT0Prefix"),
        )
        lm_params = None
        if mc.get("pretrained") and model_args.get("model_version"):
            lm_params = _try_load_hf_t5(
                model_args["model_version"], lm_cfg, param_dtype, dev
            )
        params = init_vct0_params(cfg, seed=seed, device=dev,
                                  lm_params=lm_params,
                                  param_dtype=param_dtype)
        any_int8 = lm_cfg.int8_encoder_ffn or lm_cfg.int8_encoder_attn
        calib_batches = int(tpu.get("int8_calibrate_batches", 0) or 0)
        if any_int8 and calib_batches > 0:
            # defer quantization to the executor, which calibrates
            # SmoothQuant activation maxima on the first eval batches
            # (VCT0Model.calibrate_and_quantize_int8)
            model = VCT0Model(cfg, params)
            model.pending_int8_calibration = {
                "batches": calib_batches,
                "alpha": float(tpu.get("int8_smooth_alpha", 0.5)),
            }
            return model, "vct0"
        # every int8 mode quantized once at build time (the decode step's
        # bf16 weights dropped: eval only)
        params["lm"] = quantize_int8_encoder(params["lm"], lm_cfg)
        return VCT0Model(cfg, params), "vct0"

    if model_class in ("ClipCaptionPrefix", "ClipCaptionModel"):
        base = GPT2_CONFIGS.get(mc.get("ConfigClass", "GPT2"),
                                GPT2Config.gpt2_small)
        overrides = _lm_overrides(config)
        overrides.setdefault("fused_block",
                             bool(tpu.get("fused_attention", False)))
        lm_cfg = base(dtype=compute_dtype, **overrides)
        cfg = ClipCapConfig.from_model_args(
            model_args, lm_cfg=lm_cfg,
            freeze_lm=(model_class == "ClipCaptionPrefix"),
        )
        lm_params = None
        if mc.get("pretrained") and model_args.get("model_version"):
            lm_params = _try_load_hf_gpt2(
                model_args["model_version"], lm_cfg, param_dtype, dev
            )
        params = init_clipcap_params(cfg, seed=seed, device=dev,
                                     lm_params=lm_params,
                                     param_dtype=param_dtype)
        return ClipCaptionModel(cfg, params), "clipcap"

    raise ValueError(f"unknown ModelClass: {model_class}")
