"""ViT-L/14@336 per-op accounting and long-sequence variant shootout on the
card.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/vit_l_study.py,
at its shapes (bf16, B=128, 577 tokens, head size 64, d_ff 4096; random
weights from seed 0), in three parts:

  1. end-to-end variants under the JAX study's names: the plain path
     (``xla``), the split path (plain projections around
     ``attention_core``, then ``fused_mlp_block``; ``split_fe`` with the
     exponential in bf16), the whole block (``fused_vit_block``, also with
     deferred softmax division) and the split3 kernels;
  2. 24-layer component towers: the attention half in the split and split3
     formulations, the q | k | v products in plain PyTorch,
     ``attention_core`` (also ``fast_exp``) and ``fused_mlp_block``;
  3. the analytic FLOP split of a layer.

Each rate is also given as a share of ``measured_ceiling_tflops``, the best
bf16 ``torch.matmul`` at 8192 cubed on this card in this process.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.vit_l_study \\
        [--variants a,b] [--towers c,d|none] [--trials 3] [--device cpu]

One JSON line with the card's name and power limit. ``split_c2`` /
``split_c2fe`` and ``mlp_fused_chunks*`` only split the MLP program's rows
for the TPU scheduler, so each names the timed entry whose program it runs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import torch

from ..device import make_generator, resolve_device
from ..models.clip import CLIPVisionConfig, init_clip_vision_params
from ..utils.device_stats import device_info, matmul_rates
from . import vit_studies as vs

B, K = 128, 16

# end-to-end variants: the config fields each replaces, or the timed
# variant whose program it runs
VARIANTS: Dict[str, object] = {
    "xla": dict(fused_attention=False, fused_block=False),
    "split_r2": dict(fused_block_long="split"),
    "whole": dict(fused_block_long="whole"),
    "whole_dd": dict(fused_block_long="whole_dd"),
    "split3": dict(fused_block_long="split3"),
    "split_c2": "split_r2",
    "split_fe": dict(fused_block_long="split_fe"),
    "split_c2fe": "split_fe",
}
# towers: the layer function of vit_studies.layer_functions each stacks
# (with the components of flop_split it computes), or the timed tower whose
# program it runs
TOWERS: Dict[str, object] = {
    "attn_half_split_r2": ("attn_half_split",
                           ("qkv", "scores_pv", "o_proj")),
    "attn_half_split3": ("attn_half_split3", ("qkv", "scores_pv", "o_proj")),
    "qkv_projections_xla": ("qkv_projections_xla", ("qkv",)),
    "attention_core_only": ("attention_core", ("scores_pv",)),
    "attention_core_fast_exp": ("attention_core_fast_exp", ("scores_pv",)),
    "mlp_fused_only": ("mlp_fused", ("mlp",)),
    "mlp_fused_chunks2": "mlp_fused_only",
    "mlp_fused_chunks4": "mlp_fused_only",
}


def base_config() -> CLIPVisionConfig:
    return CLIPVisionConfig.vit_l_14_336(dtype=torch.bfloat16,
                                         fast_attention=True,
                                         fused_attention=True,
                                         fused_block=True)


def main(argv: Optional[List[str]] = None) -> dict:
    args = vs.parse_args(argv, __doc__.splitlines()[0])
    dev = resolve_device(args.device)
    card = device_info(dev)
    ceiling = matmul_rates(dev)["measured_ceiling_tflops"]
    base = base_config()
    L, D, H = base.seq_len, base.width, base.num_heads
    FF = base.mlp_ratio * D
    params = init_clip_vision_params(make_generator(0, dev), base,
                                     torch.bfloat16)
    stacked = torch.randn((K, B, base.image_size, base.image_size, 3),
                          generator=make_generator(1, dev), device=dev,
                          dtype=torch.bfloat16)
    per_layer = vs.flop_split(L, D, FF)
    image_flops = base.num_layers * sum(per_layer.values())

    # ---------------- end-to-end variants ----------------
    variants = {name: spec if isinstance(spec, str) else vs.encoder(
        params, dataclasses.replace(base, **spec), stacked)
        for name, spec in vs.pick(VARIANTS, args.variants).items()}
    results = vs.run_table(variants, args.trials, K, dev, lambda _, dt: {
        "images_per_s": B / dt, "ms_per_batch128": dt * 1e3,
        **vs.tflops(image_flops, B, dt, ceiling)})

    # ---------------- component towers (24-layer stacks) ----------------
    x0 = torch.randn((B, L, D), generator=make_generator(2, dev),
                     device=dev, dtype=torch.bfloat16)
    fns = vs.layer_functions(H, D, base.layer_norm_epsilon)
    towers = {name: spec if isinstance(spec, str) else vs.tower(
        fns[spec[0]], params["blocks"], x0, K)
        for name, spec in vs.pick(TOWERS, args.towers).items()}

    def tower_fields(name: str, dt: float) -> dict:
        flops = base.num_layers * sum(per_layer[p] for p in TOWERS[name][1])
        return {"ms_per_batch128": dt * 1e3,
                "ms_per_image_24layers": dt * 1e3 / B,
                **vs.tflops(flops, B, dt, ceiling)}

    accounting = vs.run_table(towers, args.trials, K, dev, tower_fields)

    # ---------------- analytic FLOP split ----------------
    total = sum(per_layer.values())
    flops = {k: {"gflop_per_image_per_layer": v / 1e9,
                 "pct_of_layer": 100 * v / total}
             for k, v in per_layer.items()}
    result = {
        "metric": "vit_l_336_study",
        "batch": B, "k_batches": K, "trials": args.trials,
        "variants": results,
        "component_towers_24layer": accounting,
        "flop_split_per_layer": flops,
        "measured_ceiling_tflops": ceiling,
        "device": card,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
