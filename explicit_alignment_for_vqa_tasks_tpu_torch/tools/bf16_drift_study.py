"""bf16-vs-fp32 drift study at t5-large scale.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/bf16_drift_study.py.
The frozen LM runs in bfloat16; this measures where bf16 numerics diverge
with depth: one random t5-large-shaped model (24 + 24 layers, d 1024), the
same fp32 params, the forward under fp32 and under bf16 compute: the
relative error of each encoder layer, the final logits' agreement (top-1
match rate, the worst fp32 rank of the bf16 pick), and the drift through
the 20-step fed-back greedy decode (a VQA answer changes only if some
decode step's argmax flips, so the per-step flip rate bounds the
answer-level disagreement from above). The encoder runs the plain path, as
in JAX (no ``fused_encoder_attention``).

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.bf16_drift_study \\
        [--device cpu]

Prints one JSON line. ``study(params, cfg32, inputs, max_new)`` is the
body, with the config an argument, so a caller can run it at any size;
``drift_metrics`` turns the two computes' arrays into the metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, make_generator, resolve_device
from ..models.t5 import T5Config, init_t5_params, t5_decode, t5_encode
from ..ops.decoding import greedy_decode_t5
from ..utils.device_stats import device_info
from .int8_drift_study import T5_LARGE

# (batch, encoder length, teacher-forced decoder length); the decode's
# batch and steps
SHAPES = dict(batch=4, length=64, dec_len=8, dec_batch=16, max_new=20)


def study_inputs(shapes: dict, vocab_high: int, dev: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """The study's token ids from ``np.random.default_rng(0)``, drawn in
    JAX's order: the forward's encoder and decoder ids (the decoder's
    first position 0), then the decode's prompts."""
    rng = np.random.default_rng(0)
    b, length = shapes["batch"], shapes["length"]

    def ids(*shape):
        return torch.as_tensor(
            rng.integers(2, vocab_high, shape).astype(np.int32), device=dev)

    out = {"ids": ids(b, length), "dec_ids": ids(b, shapes["dec_len"])}
    out["dec_ids"][:, 0] = 0
    out["ids_d"] = ids(shapes["dec_batch"], length)
    out["mask"] = torch.ones((b, length), dtype=torch.int32, device=dev)
    out["mask_d"] = torch.ones((shapes["dec_batch"], length),
                               dtype=torch.int32, device=dev)
    return out


@torch.inference_mode()
def run_compute(params: Dict, cfg: T5Config, inputs: Dict[str, torch.Tensor],
                max_new: int) -> Tuple[Tuple[np.ndarray, np.ndarray],
                                       Tuple[np.ndarray, np.ndarray]]:
    """Under ``cfg``'s compute dtype: ((per-layer encoder states, the
    teacher-forced logits), (greedy tokens, their log-probs)), fp32
    numpy."""
    final, per_layer = t5_encode(params, cfg, input_ids=inputs["ids"],
                                 attention_mask=inputs["mask"],
                                 collect_hiddens=True)
    logits = t5_decode(params, cfg, inputs["dec_ids"], final, inputs["mask"])
    hidden = t5_encode(params, cfg, input_ids=inputs["ids_d"],
                       attention_mask=inputs["mask_d"])
    tokens, lps = greedy_decode_t5(params, cfg, hidden, inputs["mask_d"],
                                   max_new_tokens=max_new)
    return ((per_layer.float().cpu().numpy(), logits.float().cpu().numpy()),
            (tokens.cpu().numpy(), lps.float().cpu().numpy()))


def study(params: Dict, cfg32: T5Config, inputs: Dict[str, torch.Tensor],
          max_new: int) -> dict:
    """fp32 (``cfg32``) against bf16 compute on the same ``params``: the
    metrics unrounded."""
    print("fp32 forward and greedy decode...", file=sys.stderr)
    fp32, dec32 = run_compute(params, cfg32, inputs, max_new)
    print("bf16 forward and greedy decode...", file=sys.stderr)
    bf16, dec16 = run_compute(
        params, dataclasses.replace(cfg32, dtype=torch.bfloat16), inputs,
        max_new)
    return drift_metrics(fp32, bf16, dec32, dec16, max_new)


def drift_metrics(fp32: Tuple[np.ndarray, np.ndarray],
                  bf16: Tuple[np.ndarray, np.ndarray],
                  dec32: Tuple[np.ndarray, np.ndarray],
                  dec16: Tuple[np.ndarray, np.ndarray], max_new: int) -> dict:
    """JAX's metrics from each compute's (per-layer encoder states, logits)
    and (greedy tokens, log-probs), unrounded."""
    (per32, logits32), (per16, logits16) = fp32, bf16
    (tok32, lp32), (tok16, lp16) = dec32, dec16
    layer_rel = [
        float(np.linalg.norm(per16[i] - per32[i])
              / (np.linalg.norm(per32[i]) + 1e-12))
        for i in range(per32.shape[0])]
    top1 = float((logits16.argmax(-1) == logits32.argmax(-1)).mean())
    flat32 = logits32.reshape(-1, logits32.shape[-1])
    flat16 = logits16.reshape(-1, logits16.shape[-1])
    pick = flat16.argmax(-1)
    rank_of_pick = (flat32 > flat32[np.arange(len(flat32)), pick][:, None]
                    ).sum(-1)
    same = tok32 == tok16
    first_flip = np.where(same.all(axis=1), max_new, (~same).argmax(axis=1))
    on_track = np.arange(max_new)[None, :] <= first_flip[:, None]
    per_step_flip = []
    for t in range(max_new):
        rows = first_flip >= t  # rows still on the fp32 trajectory at t
        per_step_flip.append(
            float((tok32[rows, t] != tok16[rows, t]).mean())
            if rows.any() else None)
    lp_diff = np.abs(lp32 - lp16)[on_track & same]
    return {
        "per_layer_rel_error": layer_rel,
        "first_layer_rel_error": layer_rel[0],
        "last_layer_rel_error": layer_rel[-1],
        "growth_factor": layer_rel[-1] / max(layer_rel[0], 1e-9),
        "logit_top1_match": top1,
        "bf16_pick_worst_fp32_rank": int(rank_of_pick.max()),
        "logit_max_abs_diff": float(np.abs(logits16 - logits32).max()),
        "logit_rel_error": float(np.linalg.norm(logits16 - logits32)
                                 / np.linalg.norm(logits32)),
        "greedy_decode": {
            "batch": int(tok32.shape[0]), "max_new_tokens": max_new,
            "full_sequence_match_rate": float(same.all(axis=1).mean()),
            "per_step_flip_rate_on_trajectory": per_step_flip,
            "mean_first_flip_step": float(first_flip.mean()),
            "on_trajectory_logprob_mean_abs_diff": (
                float(lp_diff.mean()) if lp_diff.size else 0.0),
        },
    }


def rounded(out: dict) -> dict:
    """The JSON line's digits (JAX's)."""
    def r(value, digits):
        return None if value is None else round(value, digits)

    dec = dict(out["greedy_decode"])
    dec["full_sequence_match_rate"] = r(dec["full_sequence_match_rate"], 4)
    dec["per_step_flip_rate_on_trajectory"] = [
        r(x, 4) for x in dec["per_step_flip_rate_on_trajectory"]]
    dec["mean_first_flip_step"] = r(dec["mean_first_flip_step"], 2)
    dec["on_trajectory_logprob_mean_abs_diff"] = r(
        dec["on_trajectory_logprob_mean_abs_diff"], 5)
    return dict(
        out, per_layer_rel_error=[r(x, 5) for x in out["per_layer_rel_error"]],
        first_layer_rel_error=r(out["first_layer_rel_error"], 5),
        last_layer_rel_error=r(out["last_layer_rel_error"], 5),
        growth_factor=r(out["growth_factor"], 2),
        logit_top1_match=r(out["logit_top1_match"], 4),
        logit_max_abs_diff=r(out["logit_max_abs_diff"], 4),
        logit_rel_error=r(out["logit_rel_error"], 5), greedy_decode=dec)


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card")
    args = parser.parse_args(argv)
    dev = resolve_device(device or args.device)
    cfg32 = T5Config(**T5_LARGE, dtype=torch.float32)
    print("initializing t5-large-shaped params (fp32)...", file=sys.stderr)
    params = init_t5_params(make_generator(0, dev), cfg32, torch.float32)
    inputs = study_inputs(SHAPES, 32000, dev)
    out = rounded(study(params, cfg32, inputs, SHAPES["max_new"]))
    line = {"metric": "bf16_drift_t5_large_random", **out,
            "shapes": {"batch": SHAPES["batch"], "enc_len": SHAPES["length"],
                       "dec_len": SHAPES["dec_len"],
                       "layers": cfg32.num_encoder_layers,
                       "d_model": cfg32.d_model},
            "device": device_info(dev)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
