"""Per-step FLOP accounting of the VC-T0 mapper train step on the card.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/train_step_study.py:
Conceptual Captions mapper training through the frozen T0-3B (bf16, a
``prefix_length`` 10 mapper from 768-wide CLIP embeddings, 32 caption
tokens; reference: src/trainers/vct0_exector.py:131-167). The step is the
port's trainer step: ``vct0_caption_loss`` with the encoder attention and
FFN through their kernels' autograd forms (``t5_attention_core_vjp``,
``fused_t5_ffn_vjp``; the JAX study fuses the attention only), backward
into the mapper, an AdamW step (lr 1e-4, optax ``adamw``'s defaults), on
random weights (seed 0). Measured:

  * the full step's ms (``--steps`` chained steps, then
    ``torch.cuda.synchronize``; best of ``--trials``, each trial on a fresh
    mapper and optimizer, after one untimed run) at each ``--batches``;
  * at the first batch: ``remat`` (each layer recomputed in the backward),
    ``xla_attn`` (the encoder attention in plain PyTorch: cuBLAS products
    and a softmax; the FFN kernel stays) and ``fwd`` (the loss alone,
    without a graph; the step over it is ``step_over_fwd_ratio``: about 2
    when the frozen LM's weight gradients are skipped, about 3 when not);
  * the analytic FLOPs (forward plus the activation-gradient backward,
    ``t5_train_flops_per_example``) over the time, as TFLOP/s and as a share
    of ``measured_ceiling_tflops``: the best bf16 ``torch.matmul`` at
    8192 cubed on this card in this process
    (``utils.device_stats.matmul_rates``);
  * ``int8_forward_bound``: what a W8A8 forward could save at most, from
    ``int8_over_bf16_rate`` (``torch._int_mm`` against that matmul, measured
    beside it).

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.train_step_study \\
        [--batches 32,64,128,256] [--caption_len 32] [--steps 8] [--trials 3] \\
        [--variants base,remat,xla_attn,fwd] [--tiny] [--device cpu]

``--tiny`` runs the JAX study's tiny fp32 widths (numbers not meaningful).
One JSON line goes to stdout with the card's name and power limit; on the
CPU the ceiling and the rates are null (not measured). ``study`` takes the
parsed flags, the device and, optionally, the params, so that a test can
carry weights in.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.mappers import MapperConfig
from ..models.t5 import T5Config
from ..models.vct0 import VCT0Config, init_vct0_params, vct0_caption_loss
from ..trainers.optimization import tree_leaves
from ..utils.device_stats import device_info, matmul_rates
from .bench_train import LR, OPTAX_ADAMW_WEIGHT_DECAY

VARIANTS = ("base", "remat", "xla_attn", "fwd")


def t5_train_flops_per_example(cfg, enc_len: int, dec_len: int,
                               with_dw: bool = False) -> float:
    """Analytic matmul FLOPs per example for the captioning step.

    Forward: 2 * (active params) * tokens per component; backward adds
    one dx matmul per forward matmul (~1x forward) — dW matmuls for the
    FROZEN LM are excluded unless with_dw. Attention score/PV terms
    included; layernorms/softmax ignored (<2%)."""
    d, dff, h, dkv = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.d_kv
    inner = h * dkv
    attn_proj = 4 * d * inner              # q,k,v,o
    ffn = 3 * d * dff                      # gated: wi_0, wi_1, wo
    enc_layer = attn_proj + ffn
    dec_layer = 2 * attn_proj + ffn        # self + cross
    enc = cfg.num_encoder_layers * (
        2 * enc_layer * enc_len            # param matmuls
        + 2 * (2 * enc_len * enc_len * inner)   # scores + PV
    )
    dec = cfg.num_decoder_layers * (
        2 * dec_layer * dec_len
        + 2 * (2 * dec_len * dec_len * inner)       # self scores+PV
        + 2 * (2 * dec_len * enc_len * inner)       # cross scores+PV
    )
    head = 2 * d * cfg.vocab_size * dec_len
    fwd = float(enc + dec + head)
    bwd_factor = 2.0 if with_dw else 1.0   # dx always; dW only if asked
    return fwd * (1.0 + bwd_factor)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", default="32,64,128,256")
    parser.add_argument("--caption_len", type=int, default=32)
    parser.add_argument("--steps", type=int, default=8,
                        help="train steps chained per timed synchronize")
    parser.add_argument("--trials", type=int, default=3)
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma subset of base,remat,xla_attn,fwd; "
                        "variants beyond base run at the FIRST batch size")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny fp32 dims (numbers not meaningful)")
    parser.add_argument("--device", default=None,
                        help="the card unless given (cpu: plain versions)")
    return parser


def make_cfg(tiny: bool, **over) -> Tuple[VCT0Config, int, int]:
    """(config, prefix_size, prefix_length): T0-3B in bf16 with the two
    encoder kernels, or the tiny fp32 T5; ``over`` replaces LM fields."""
    if tiny:
        lm = T5Config.small_test(num_heads=4, d_ff=64, **over)
        prefix_size, n_prefix = 16, 2
    else:
        kw = dict(dtype=torch.bfloat16, fused_encoder_attention=True,
                  fused_encoder_ffn=True)
        kw.update(over)
        lm = T5Config.t0_3b(**kw)
        prefix_size, n_prefix = 768, 10
    mapper = MapperConfig(prefix_size=prefix_size, d_model=lm.d_model,
                          prefix_length=n_prefix, clip_length=n_prefix)
    return VCT0Config(lm=lm, mapper=mapper), prefix_size, n_prefix


def _clone(tree: Dict[str, Any], grad: bool) -> Dict[str, Any]:
    return {k: _clone(v, grad) if isinstance(v, dict)
            else v.detach().clone().requires_grad_(grad)
            for k, v in tree.items()}


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def measure(args: argparse.Namespace, cfg: VCT0Config, params: Dict,
            batch: int, prefix_size: int, n_prefix: int, dev: torch.device,
            ceiling: Optional[float], forward_only: bool = False) -> dict:
    """One point: a warm run of ``args.steps`` steps, then the best of
    ``args.trials`` timed runs, each on a fresh mapper and optimizer."""
    rng = np.random.default_rng(0)
    clip = torch.from_numpy(rng.standard_normal(
        (batch, prefix_size)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(
        2, cfg.lm.vocab_size - 100, size=(batch, args.caption_len),
    ).astype(np.int32)).to(dev)
    lm = params["lm"]

    def run() -> Tuple[List[torch.Tensor], float]:
        mapper = _clone(params["mapper"], grad=not forward_only)
        optimizer = None if forward_only else torch.optim.AdamW(
            tree_leaves(mapper), lr=LR, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=OPTAX_ADAMW_WEIGHT_DECAY)
        t0 = _sync(dev)
        losses = []
        for _ in range(args.steps):
            if forward_only:
                with torch.no_grad():
                    loss = vct0_caption_loss(mapper, lm, cfg, clip, labels)
            else:
                loss = vct0_caption_loss(mapper, lm, cfg, clip, labels)
                loss.backward()
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
            losses.append(loss.detach())
        return losses, (_sync(dev) - t0) / args.steps

    losses, first_s = run()
    print(f"  first run: {first_s * args.steps:.1f}s", file=sys.stderr)
    best = float("inf")
    for _ in range(args.trials):
        last, seconds = run()
        best = min(best, seconds)
    flops = t5_train_flops_per_example(cfg.lm, n_prefix, args.caption_len)
    if forward_only:
        flops = flops / 2.0   # fwd is half of fwd + 1x-dx-bwd
    achieved = batch * flops / best / 1e12
    return {
        "ms_per_step": best * 1e3,
        "examples_per_s": batch / best,
        "analytic_gflop_per_example": flops / 1e9,
        "achieved_tflops_per_s": achieved,
        "pct_of_measured_ceiling": (None if ceiling is None
                                    else 100 * achieved / ceiling),
        "first_loss": float(losses[0]),
        "final_loss": float(last[-1]),
    }


def int8_forward_bound(step_ms: float, fwd_ms: float,
                       rate: Optional[float]) -> dict:
    """The most a W8A8 forward through the frozen LM could save: the int8
    products at ``rate`` times the bf16 ones remove at most (1 - 1/rate) of
    the forward's time, nothing where int8 is not faster; the dx backward
    stays bf16."""
    out = {"assumption": "W8A8 forward through the frozen LM at the "
                         "measured torch._int_mm / bf16 torch.matmul rate "
                         "ratio; dx backward stays bf16",
           "int8_over_bf16_rate": rate, "max_step_speedup": None,
           "max_saved_ms": None}
    if rate is not None:
        saved = max(0.0, fwd_ms * (1 - 1 / rate))
        out.update(max_step_speedup=step_ms / (step_ms - saved),
                   max_saved_ms=saved)
    return out


def _point(what: str, fn) -> dict:
    """``fn()``, or its error recorded (the study goes on)."""
    print(what, file=sys.stderr)
    try:
        return fn()
    except Exception as exc:  # one point's failure is a result of its own
        traceback.print_exc()
        return {"error": str(exc)[:200]}


def study(args: argparse.Namespace, device: DeviceLike = None,
          params: Optional[Dict] = None) -> dict:
    """The batch sweep, the variants and the bound; the result line."""
    dev = resolve_device(device)
    card = device_info(dev)
    rates = matmul_rates(dev)
    ceiling = rates["measured_ceiling_tflops"]
    print(f"device: {card}; rates: {rates}", file=sys.stderr)
    cfg, prefix_size, n_prefix = make_cfg(args.tiny)
    if params is None:
        params = init_vct0_params(cfg, seed=0, device=dev,
                                  param_dtype=cfg.lm.dtype)

    def point(cfg_v: VCT0Config, batch: int, **kw) -> dict:
        return measure(args, cfg_v, params, batch, prefix_size, n_prefix,
                       dev, ceiling, **kw)

    batches = [int(b) for b in args.batches.split(",") if b]
    variants = [v.strip() for v in args.variants.split(",") if v.strip()]
    results: Dict[str, Any] = {"batch_sweep": {}, "variants": {}}
    for batch in batches:
        results["batch_sweep"][str(batch)] = _point(
            f"batch {batch} (base)", lambda: point(cfg, batch))
    b0 = batches[0]
    base = results["batch_sweep"].get(str(b0), {})
    others = {
        "fwd": lambda: point(cfg, b0, forward_only=True),
        "remat": lambda: point(make_cfg(args.tiny, remat=True)[0], b0),
        "xla_attn": lambda: point(
            make_cfg(args.tiny, fused_encoder_attention=False)[0], b0),
    }
    for variant in variants:
        if variant == "base":
            results["variants"]["base"] = base
        elif variant in others:
            results["variants"][variant] = _point(
                f"variant {variant} @ B={b0}", others[variant])
        else:
            raise ValueError(f"unknown variant {variant}")
    fwd = results["variants"].get("fwd", {})
    if "ms_per_step" in fwd and "ms_per_step" in base:
        fwd["step_over_fwd_ratio"] = base["ms_per_step"] / fwd["ms_per_step"]
        results["int8_forward_bound"] = int8_forward_bound(
            base["ms_per_step"], fwd["ms_per_step"],
            rates["int8_over_bf16_rate"])
    return {
        "metric": "vct0_3b_mapper_train_step_study",
        "config": {"caption_len": args.caption_len,
                   "prefix_length": n_prefix,
                   "steps_per_fetch": args.steps, "trials": args.trials,
                   "tiny": args.tiny,
                   "fused_encoder_attention": cfg.lm.fused_encoder_attention,
                   "fused_encoder_ffn": cfg.lm.fused_encoder_ffn,
                   **rates},
        **results,
        "device": card,
    }


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    result = study(args, device=args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
