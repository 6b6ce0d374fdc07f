"""int8-encoder-vs-bf16 drift study.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/int8_drift_study.py.
The opt-in bulk-eval modes (``int8_encoder_ffn`` + ``int8_encoder_attn``)
quantize the frozen LM's encoder matmuls to int8; this measures what that
does to the ANSWERS: one t5-large-shaped model, identical params, the
encoder's drift by depth and the 20-step fed-back greedy decode (a VQA
answer changes only if some decode step's argmax flips, so the flip rate
bounds the answer-level disagreement from above). The baseline is the bf16
path with the ``t5_attention_core`` kernel; the variants run rows 1–4 of
the port's kernels (``t5_attention_core``, ``fused_t5_ln_qkv_q8``,
``fused_oproj_residual_q8``, ``fused_t5_ffn_q8``) on the card:

  * per_channel — one scale over the whole contraction dim;
  * grouped — per-(contraction group, output channel) weight scales and
    per-(row, group) activation scales;
  * grouped_smooth — grouped plus SmoothQuant factors from activation
    maxima calibrated on the study's inputs;
  * full_stack — grouped_smooth plus the int8 cross-attention KV cache.

``--mode outlier`` gives the encoder's RMS-norm scales heavy-tailed
per-channel factors (``np.random.default_rng(7)``, as in the JAX package):
the activation outliers trained transformers show, which random init lacks.
Trained weights have larger logit margins than random init, so their
agreement is expected to be better than reported here (``--weights`` runs
the study on a local HF T5 checkpoint, which needs ``transformers``).

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.int8_drift_study \\
        [--mode normal|outlier|both] [--tiny] [--weights DIR] [--device cpu]

Prints one JSON line. ``run_mode(params, cfg, ids, mask, max_new)`` is the
study's body, so a caller can give it any params.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, make_generator, resolve_device
from ..models.t5 import (
    T5Config,
    calibrate_encoder_act_max,
    init_t5_params,
    quantize_encoder_attn,
    quantize_encoder_ffn,
    t5_encode,
)
from ..ops.decoding import greedy_decode_t5
from ..utils.device_stats import device_info

Params = Dict
# t5-large (~770M params)
T5_LARGE = dict(vocab_size=32128, d_model=1024, d_kv=64, num_heads=16,
                d_ff=2816, num_encoder_layers=24, num_decoder_layers=24)
TINY = dict(vocab_size=512, d_model=64, d_kv=16, num_heads=4, d_ff=128,
            num_encoder_layers=3, num_decoder_layers=2)
VARIANTS = ("per_channel", "grouped", "grouped_smooth", "full_stack")


def study_inputs(cfg: T5Config, batch: int, length: int,
                 dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, mask) from ``np.random.default_rng(0)``, as in JAX."""
    rng = np.random.default_rng(0)
    ids = rng.integers(2, min(32000, cfg.vocab_size - 8), (batch, length))
    return (torch.as_tensor(ids.astype(np.int32), device=dev),
            torch.ones((batch, length), dtype=torch.int32, device=dev))


def with_outlier_norms(params: Params) -> Params:
    """The encoder's ln0 / ln1 scales times heavy-tailed per-channel
    factors: a log-normal body and 4 hard outliers (x10-30) a layer, drawn
    from ``np.random.default_rng(7)`` in JAX's order."""
    orng = np.random.default_rng(7)
    enc = dict(params["encoder"])
    for ln_name in ("ln0", "ln1"):
        w = enc[ln_name].float().cpu().numpy()
        fac = np.exp(orng.normal(0.0, 0.6, size=w.shape))
        for li in range(w.shape[0]):
            hot = orng.choice(w.shape[1], size=4, replace=False)
            fac[li, hot] *= orng.uniform(10.0, 30.0, size=4)
        enc[ln_name] = torch.as_tensor(
            (w * fac).astype(np.float32), device=enc[ln_name].device
        ).to(enc[ln_name].dtype)
    return dict(params, encoder=enc)


def quantized_variants(params: Params, cfg: T5Config, ids: torch.Tensor,
                       mask: torch.Tensor) -> Dict[str, Tuple[Params, T5Config]]:
    """Each variant's (params, config); SmoothQuant calibrated on
    (ids, mask)."""
    cfg_q8 = dataclasses.replace(cfg, int8_encoder_ffn=True,
                                 int8_encoder_attn=True)
    stats = calibrate_encoder_act_max(params, cfg, [(ids, mask)])
    smooth = quantize_encoder_attn(
        quantize_encoder_ffn(params, act_max=stats["ffn"]),
        act_max=stats["attn"])
    return {
        "per_channel": (quantize_encoder_attn(
            quantize_encoder_ffn(params, groups=1), groups=1), cfg_q8),
        "grouped": (quantize_encoder_attn(quantize_encoder_ffn(params)),
                    cfg_q8),
        "grouped_smooth": (smooth, cfg_q8),
        "full_stack": (smooth, dataclasses.replace(cfg_q8,
                                                   int8_cross_kv=True)),
    }


@torch.inference_mode()
def encode_and_decode(params: Params, cfg: T5Config, ids: torch.Tensor,
                      mask: torch.Tensor, max_new: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(per-layer encoder states (layers, B, L, D) fp32, greedy tokens,
    their log-probs fp32), as numpy."""
    hidden, per_layer = t5_encode(params, cfg, input_ids=ids,
                                  attention_mask=mask, collect_hiddens=True)
    tokens, lps = greedy_decode_t5(params, cfg, hidden, mask,
                                   max_new_tokens=max_new)
    return (per_layer.float().cpu().numpy(), tokens.cpu().numpy(),
            lps.float().cpu().numpy())


def drift_metrics(ref: Tuple[np.ndarray, ...], got: Tuple[np.ndarray, ...],
                  max_new: int) -> dict:
    """JAX's metrics of ``got`` against ``ref`` (each encode_and_decode's
    triple), unrounded, with the error of every layer."""
    per_ref, tok_ref, lp_ref = ref
    per_got, tok_got, lp_got = got
    layer_rel = [float(np.linalg.norm(b - a) / np.linalg.norm(a))
                 for a, b in zip(per_ref, per_got)]
    same = tok_ref == tok_got
    first_flip = np.where(same.all(axis=1), max_new, (~same).argmax(axis=1))
    on_track = np.arange(max_new)[None, :] <= first_flip[:, None]
    lp_diff = np.abs(lp_ref - lp_got)[on_track & same]
    return {
        "per_layer_rel_error": layer_rel,
        "first_layer_rel_error": layer_rel[0],
        "last_layer_rel_error": layer_rel[-1],
        "growth_factor": layer_rel[-1] / max(layer_rel[0], 1e-9),
        "full_sequence_match_rate": float(same.all(axis=1).mean()),
        "mean_first_flip_step": float(first_flip.mean()),
        "on_trajectory_logprob_mean_abs_diff": (
            float(lp_diff.mean()) if lp_diff.size else 0.0),
    }


def rounded(metrics: dict) -> dict:
    """The JSON line's digits (JAX's)."""
    digits = {"growth_factor": 2, "full_sequence_match_rate": 4,
              "mean_first_flip_step": 2}
    return {key: ([round(x, 5) for x in value] if isinstance(value, list)
                  else round(value, digits.get(key, 5)))
            for key, value in metrics.items()}


def run_mode(params: Params, cfg: T5Config, ids: torch.Tensor,
             mask: torch.Tensor, max_new: int) -> Dict[str, dict]:
    """Every variant's drift_metrics against the bf16 path of ``cfg`` on
    ``params``."""
    variants = quantized_variants(params, cfg, ids, mask)
    print("bf16 baseline encode+decode...", file=sys.stderr)
    ref = encode_and_decode(params, cfg, ids, mask, max_new)
    out = {}
    for name, (params_q8, cfg_v) in variants.items():
        print(f"variant {name}...", file=sys.stderr)
        out[name] = drift_metrics(
            ref, encode_and_decode(params_q8, cfg_v, ids, mask, max_new),
            max_new)
    return out


def load_hf_weights(weights: str, dev: torch.device
                    ) -> Tuple[T5Config, Params]:
    """A local HF T5 checkpoint through models/hf_convert.py: fp32 at
    d_model <= 256, else bf16."""
    import transformers

    from ..convert import t5_params_from_numpy
    from ..models.hf_convert import t5_params_from_hf

    with open(os.path.join(weights, "config.json")) as fh:
        hf = json.load(fh)
    dtype = torch.float32 if hf["d_model"] <= 256 else torch.bfloat16
    cfg = T5Config(
        vocab_size=hf["vocab_size"], d_model=hf["d_model"], d_kv=hf["d_kv"],
        num_heads=hf["num_heads"], d_ff=hf["d_ff"],
        num_encoder_layers=hf["num_layers"],
        num_decoder_layers=hf.get("num_decoder_layers", hf["num_layers"]),
        relative_attention_num_buckets=hf["relative_attention_num_buckets"],
        relative_attention_max_distance=hf.get(
            "relative_attention_max_distance", 128),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        dtype=dtype, fused_encoder_attention=True,
    )
    model = transformers.T5ForConditionalGeneration.from_pretrained(
        weights, local_files_only=True, torch_dtype="float32")
    params = t5_params_from_numpy(t5_params_from_hf(model.state_dict(), cfg),
                                  dtype, dev)
    return cfg, params


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", choices=("normal", "outlier", "both"),
                        default="both")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny shapes, so the variants' machinery runs "
                             "on the CPU in seconds (numbers not meaningful)")
    parser.add_argument("--weights", default="",
                        help="local HF T5 checkpoint dir: the study on "
                             "trained weights (needs transformers)")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(device or args.device)
    if args.weights:
        cfg, loaded = load_hf_weights(args.weights, dev)
        small = cfg.d_model <= 256
        batch, length, max_new = (4, 32, 8) if small else (16, 64, 20)
    elif args.tiny:
        cfg = T5Config(**TINY, dtype=torch.float32,
                       fused_encoder_attention=True)
        batch, length, max_new = 2, 16, 4
    else:
        cfg = T5Config(**T5_LARGE, dtype=torch.bfloat16,
                       fused_encoder_attention=True)
        batch, length, max_new = 16, 64, 20
    ids, mask = study_inputs(cfg, batch, length, dev)

    def params_of(mode: str) -> Params:
        print(f"== {mode}: initializing params ==", file=sys.stderr)
        if args.weights:
            return loaded
        params = init_t5_params(make_generator(0, dev), cfg, torch.bfloat16)
        return with_outlier_norms(params) if mode == "outlier" else params

    result = {
        "metric": "int8_encoder_drift_vs_bf16_t5_large_random",
        "modes": ["int8_encoder_ffn", "int8_encoder_attn"],
        "shapes": {"batch": batch, "enc_len": length,
                   "layers": cfg.num_encoder_layers,
                   "d_model": cfg.d_model, "max_new_tokens": max_new,
                   "tiny": bool(args.tiny)},
        "device": device_info(dev),
    }
    if args.weights:
        # trained weights carry their own activation structure; the
        # synthetic outliers are for random init only
        result["metric"] = "int8_encoder_drift_vs_bf16_trained_weights"
        result["weights"] = args.weights
        modes = ["trained"]
    else:
        modes = {"both": ["normal", "outlier"]}.get(args.mode, [args.mode])
    for mode in modes:
        result[mode] = {
            name: rounded(metrics) for name, metrics in run_mode(
                params_of(mode), cfg, ids, mask, max_new).items()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
