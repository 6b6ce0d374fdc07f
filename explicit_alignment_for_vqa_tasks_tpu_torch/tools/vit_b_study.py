"""ViT-B/32@224 per-op accounting and variant shootout on the card.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/vit_b_study.py,
at its shapes (bf16, B=1024, 50 tokens, head size 64, d_ff 3072; random
weights from seed 0), in three parts:

  1. end-to-end variants under the JAX study's names: the whole-block
     kernel (``fused_vit_block``, also with its exponential in bf16), the
     split3 kernels, the fused attention block, and the plain path
     (cuBLAS products, fp32 logits made bf16, ``fast_attention``);
  2. 12-layer component towers of one layer function each: the whole
     block, the q | k | v products in plain PyTorch, ``fused_ln_qkv``,
     ``attention_core``, ``attention_core_oproj``, ``fused_mlp_block``, and
     the encoder minus its blocks (``patch_embed_only``);
  3. the analytic FLOP split of a layer.

Each rate is also given as a share of ``measured_ceiling_tflops``, the best
bf16 ``torch.matmul`` at 8192 cubed on this card in this process.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.vit_b_study \\
        [--variants a,b] [--towers c,d|none] [--trials 3] [--device cpu]

One JSON line with the card's name and power limit. The JAX study's
variants that differ only in ``fused_block_group`` run one program here
(``vit_studies``), so each is timed once and the others name it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import torch

from ..device import make_generator, resolve_device
from ..models.clip import CLIPVisionConfig, init_clip_vision_params, \
    patch_embed
from ..utils.device_stats import device_info, matmul_rates
from . import vit_studies as vs

B, K = 1024, 16

# end-to-end variants: the config fields each replaces, or the timed
# variant whose program it runs
VARIANTS: Dict[str, object] = {
    "xla": dict(fused_attention=False, fused_block=False),
    "fused_attention_only": dict(fused_block=False),
    "whole_g1": "whole_g4_shipped",
    "whole_g2": "whole_g4_shipped",
    "whole_g4_shipped": dict(fused_block_group=4),
    "whole_g8": "whole_g4_shipped",
    "whole_g16": "whole_g4_shipped",
    "whole_g4_fe": dict(fused_block_group=4, fused_block_long="whole_fe"),
    "whole_g8_fe": "whole_g4_fe",
    "split3_g4": dict(fused_block_long="split3", fused_block_group=4),
    "split3_g8": "split3_g4",
    "split3_g16": "split3_g4",
    "split3_g32": "split3_g4",
}
# towers: the layer function of vit_studies.layer_functions each stacks
# (with the components of flop_split it computes), or the timed tower whose
# program it runs
TOWERS: Dict[str, object] = {
    "whole_block_g4": ("whole_block", ("qkv", "scores_pv", "o_proj", "mlp")),
    "whole_block_g8": "whole_block_g4",
    "qkv_projections_xla": ("qkv_projections_xla", ("qkv",)),
    "ln_qkv_fused_g8": ("ln_qkv_fused", ("qkv",)),
    "attention_core_g4": ("attention_core", ("scores_pv",)),
    "attention_core_g8": "attention_core_g4",
    "core_oproj_g8": ("core_oproj", ("scores_pv", "o_proj")),
    "mlp_fused_g4": ("mlp_fused", ("mlp",)),
    "mlp_fused_g8": "mlp_fused_g4",
    "mlp_fused_g16": "mlp_fused_g4",
}


def base_config() -> CLIPVisionConfig:
    return CLIPVisionConfig.vit_b_32(dtype=torch.bfloat16,
                                     fast_attention=True,
                                     fused_attention=True, fused_block=True)


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
    gen = make_generator(1, dev)
    stacked = torch.randn((K, B, base.image_size, base.image_size, 3),
                          generator=gen, device=dev, dtype=torch.bfloat16)
    per_layer = vs.flop_split(L, D, FF)
    image_flops = base.num_layers * sum(per_layer.values())

    # ---------------- end-to-end variants ----------------
    variants = {name: spec if isinstance(spec, str) else vs.encoder(
        params, dataclasses.replace(base, **spec), stacked)
        for name, spec in vs.pick(VARIANTS, args.variants).items()}
    results = vs.run_table(variants, args.trials, K, dev, lambda _, dt: {
        "images_per_s": B / dt, "ms_per_batch1024": dt * 1e3,
        **vs.tflops(image_flops, B, dt, ceiling)})

    # ---------------- component towers (12-layer stacks) ----------------
    x0 = torch.randn((B, L, D), generator=make_generator(2, dev),
                     device=dev, dtype=torch.bfloat16)
    fns = vs.layer_functions(H, D, base.layer_norm_epsilon)
    towers = {name: spec if isinstance(spec, str) else vs.tower(
        fns[spec[0]], params["blocks"], x0, K)
        for name, spec in vs.pick(TOWERS, args.towers).items()}

    @torch.inference_mode()
    def embed_only() -> torch.Tensor:
        # patch-embed + final LN/proj overhead: the encoder minus the blocks
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for images in stacked:
            total += patch_embed(params, base, images).float().sum()
        return total

    if not args.towers or "patch_embed_only" in args.towers.split(","):
        towers["patch_embed_only"] = embed_only

    def tower_fields(name: str, dt: float) -> dict:
        if name == "patch_embed_only":
            return {"ms_per_batch1024": dt * 1e3,
                    "us_per_image": dt * 1e6 / B}
        flops = base.num_layers * sum(per_layer[p] for p in TOWERS[name][1])
        return {"ms_per_batch1024": dt * 1e3,
                "us_per_image_12layers": dt * 1e6 / B,
                **vs.tflops(flops, B, dt, ceiling)}

    accounting = vs.run_table(towers, args.trials, K, dev, tower_fields)

    # ---------------- analytic FLOP split ----------------
    total = sum(per_layer.values())
    flops = {k: {"mflop_per_image_per_layer": v / 1e6,
                 "pct_of_layer": 100 * v / total}
             for k, v in per_layer.items()}
    result = {
        "metric": "vit_b_32_study",
        "batch": B, "k_batches": K, "trials": args.trials,
        "variants": results,
        "component_towers_12layer": accounting,
        "flop_split_per_layer": flops,
        "measured_ceiling_tflops": ceiling,
        "device": card,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
