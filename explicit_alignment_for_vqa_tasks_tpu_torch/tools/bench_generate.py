"""Few-shot VQA generation throughput of the port, in prompts/s on one card.

Counterpart of the root ``bench_generate.py`` (the JAX package's): the
prefix splice, the T0-3B encoder and a 20-step greedy decode with a KV cache
through ``VCT0Model.generate``, on random T0-3B weights (seed 0) at the same
defaults (B=32, 512 prompt tokens, 4 shots, 20 decode steps, 3 trials) and
with the same flags:

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.bench_generate \\
        [--batch 32] [--seq 512] [--fused_ffn] [--int8_ffn --int8_attn] \\
        [--eos_step1 | --eos_at_steps 2,3,4,5] [--prefill_chunks 2] \\
        [--ensembles 3 --members_per_call 3] ...

``--ensembles E`` times the prompt-permutation ensemble instead
(``trainers.few_shot_vqa_executor.ensemble_generate``: E members a
question, the summed-log-prob pick on the host); ``--prefill_chunks`` and
``--eos_at_steps`` act on the main generate path only, so the bench
refuses them beside ``--ensembles`` (the JAX bench records them there
although that path ignores them). Each trial is timed by the host clock
up to ``torch.cuda.synchronize()``; per-trial lines go to stderr, and one
JSON line to stdout with the JAX bench's metric name and ``config`` keys,
plus the card's name and power limit. There is no scoped-VMEM limit or
compilation cache to set (TPU-only knobs). ``bench`` takes the parsed
flags, the base T5 config and the device, so that a test can run it at a
small width on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import t5 as t5_lib
from ..models.mappers import MapperConfig
from ..models.t5 import T5Config
from ..models.vct0 import VCT0Config, VCT0Model, init_vct0_params
from ..ops.prefix_splice import T5_SENTINEL_BASE
from ..trainers.few_shot_vqa_executor import ensemble_generate
from ..utils.device_stats import device_info

METRIC = "vct0_3b_fewshot_generate_prompts_per_sec_per_chip"
PREFIX_SIZE = 768     # CLIP ViT-L/14@336 embedding width
PREFIX_LENGTH = 10


def build_parser() -> argparse.ArgumentParser:
    """The JAX bench's flags, with the same names and defaults."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seq", type=int, default=512)
    parser.add_argument("--shots", type=int, default=4)
    parser.add_argument("--decode_steps", type=int, default=20)
    parser.add_argument("--trials", type=int, default=3)
    parser.add_argument("--fused_ffn", action="store_true",
                        help="the encoder FFN through the fused_t5_ffn kernel")
    parser.add_argument("--int8_cross_kv", action="store_true",
                        help="int8 cross-attention KV cache")
    parser.add_argument("--int8_ffn", action="store_true",
                        help="int8 encoder FFN (opt-in bulk-eval mode)")
    parser.add_argument("--int8_kv_layout", type=str, default="auto",
                        choices=["auto", "unmerged", "merged", "transposed"],
                        help="cross-KV storage layout (auto = transposed "
                        "iff B>=96 else unmerged)")
    parser.add_argument("--int8_groups", type=int, default=0,
                        help="contraction groups of the int8 encoder "
                        "quantizers: 0 = auto, 1 = per-channel")
    parser.add_argument("--eos_step1", action="store_true",
                        help="a zero lm_head and eos 0: every row emits EOS "
                        "at decode step 1 (the early exit's best case)")
    parser.add_argument("--eos_at_steps", type=str, default="",
                        help="comma list, e.g. '2,3,4,5': each row finishes "
                        "at a step drawn (per row, seeded) from the list")
    parser.add_argument("--int8_attn", action="store_true",
                        help="int8 encoder QKV/O projections")
    parser.add_argument("--int8_decoder", action="store_true",
                        help="weight-only int8 decode-step matmuls")
    parser.add_argument("--prefill_chunks", type=int, default=1,
                        help="the encoder and cross-KV cache build in N "
                        "batch chunks (value-equal; a smaller prefill peak)")
    parser.add_argument("--ensembles", type=int, default=0,
                        help="E > 0: time the prompt-permutation ensemble, "
                        "E members a question")
    parser.add_argument("--members_per_call", type=int, default=1,
                        help="with --ensembles: m members folded into the "
                        "batch of each generate call (batch * m rows)")
    return parser


def check_flags(args: argparse.Namespace) -> None:
    """Refuse the main-path knobs beside --ensembles, whose path ignores
    them."""
    if args.ensembles > 0 and (args.prefill_chunks != 1
                               or args.eos_at_steps):
        raise ValueError(
            "bench_generate: --prefill_chunks and --eos_at_steps act on the "
            "main generate path only, not beside --ensembles")


def build_model(args: argparse.Namespace, base: T5Config,
                dev: torch.device) -> VCT0Model:
    """The bench's model: ``base`` in bf16 with the attention kernel and
    the flags' options, an mlp mapper from 768 to 10 prefix positions,
    random params from seed 0, quantized once for the int8 flags."""
    lm_cfg = dataclasses.replace(
        base, dtype=torch.bfloat16, fused_encoder_attention=True,
        fused_encoder_ffn=args.fused_ffn, int8_cross_kv=args.int8_cross_kv,
        int8_kv_layout=(None if args.int8_kv_layout == "auto"
                        else args.int8_kv_layout),
        int8_encoder_ffn=args.int8_ffn, int8_encoder_attn=args.int8_attn,
        int8_decoder_step=args.int8_decoder)
    if args.eos_step1:
        # all logits equal: argmax is token 0, the eos, at step 1
        lm_cfg = dataclasses.replace(lm_cfg, eos_token_id=0)
    cfg = VCT0Config(
        lm=lm_cfg,
        mapper=MapperConfig(prefix_size=PREFIX_SIZE, d_model=lm_cfg.d_model,
                            prefix_length=PREFIX_LENGTH,
                            clip_length=PREFIX_LENGTH),
    )
    params = init_vct0_params(cfg, seed=0, device=dev,
                              param_dtype=torch.bfloat16)
    groups = "auto" if args.int8_groups <= 0 else args.int8_groups
    lm = params["lm"]
    if args.eos_step1:
        lm["lm_head"] = torch.zeros_like(lm["lm_head"])
    if lm_cfg.int8_encoder_ffn:
        lm = t5_lib.quantize_encoder_ffn(lm, groups=groups)
    if lm_cfg.int8_encoder_attn:
        lm = t5_lib.quantize_encoder_attn(lm, groups=groups)
    if lm_cfg.int8_decoder_step:
        # the bf16 decoder copies are dead in eval (W8A16 reads the codes)
        lm = t5_lib.quantize_decoder_step(lm, groups=groups, drop_bf16=True)
    params["lm"] = lm
    return VCT0Model(cfg, params)


def bench(args: argparse.Namespace, base: Optional[T5Config] = None,
          device: DeviceLike = None) -> dict:
    """Build the model and time ``args.trials`` generate calls after a
    first one; returns the result line's fields."""
    check_flags(args)
    dev = resolve_device(device)
    base = T5Config.t0_3b() if base is None else base
    print(f"device: {dev}", file=sys.stderr)
    model = build_model(args, base, dev)

    B, L, P = args.batch, args.seq, args.shots + 1
    rng = np.random.default_rng(0)
    tokens = rng.integers(10, 30000, size=(B, L)).astype(np.int32)
    for i in range(P):  # one sentinel per prefix at spaced positions
        tokens[:, i * (L // P)] = T5_SENTINEL_BASE - i
    mask = np.ones((B, L), dtype=np.int32)
    prefix = rng.standard_normal((B, P, PREFIX_SIZE)).astype(np.float32)
    tokens_d = torch.from_numpy(tokens).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    prefix_d = torch.from_numpy(prefix).to(dev)
    force_eos_at, mean_forced_len = None, None
    if args.eos_at_steps:
        steps = [int(s) for s in args.eos_at_steps.split(",") if s]
        sampled = rng.choice(np.asarray(steps, np.int32), size=B)
        mean_forced_len = float(sampled.mean())
        force_eos_at = torch.from_numpy(sampled.astype(np.int32)).to(dev)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if args.ensembles > 0:
        E = args.ensembles
        ens_tokens = rng.integers(10, 30000, size=(B, E, L)).astype(np.int32)
        for i in range(P):
            ens_tokens[:, :, i * (L // P)] = T5_SENTINEL_BASE - i
        ens_mask = torch.ones((B, E, L), dtype=torch.int32, device=dev)
        ens_prefix = torch.from_numpy(rng.standard_normal(
            (B, E, P, PREFIX_SIZE)).astype(np.float32)).to(dev)
        ens_tokens = torch.from_numpy(ens_tokens).to(dev)

        def call() -> None:
            # the pick is made on the host, so the call ends in a fetch
            ensemble_generate(
                model, ens_tokens, ens_mask, ens_prefix, num_ensembles=E,
                num_shots=None, no_prefix=False,
                max_new_tokens=args.decode_steps, mode="permutation",
                members_per_call=args.members_per_call)
    else:
        def call() -> None:
            model.generate(prefix=prefix_d, question_tokens=tokens_d,
                           question_mask=mask_d,
                           max_new_tokens=args.decode_steps,
                           force_eos_at=force_eos_at,
                           prefill_chunks=args.prefill_chunks)

    def step() -> float:
        sync()
        t0 = time.perf_counter()
        call()
        sync()
        return time.perf_counter() - t0

    print(f"first call: {step():.3f}s", file=sys.stderr)
    best = 0.0
    for _ in range(args.trials):
        dt = step()
        best = max(best, B / dt)
        print(f"step: {dt:.3f}s -> {B / dt:.2f} prompts/s", file=sys.stderr)
    return {
        "metric": METRIC,
        "value": round(best, 2),
        "unit": "prompts/s",
        "config": {
            "batch": B, "prompt_tokens": L, "shots": args.shots,
            "decode_steps": args.decode_steps,
            "spliced_length": L + (PREFIX_LENGTH - 1) * P,
            "eos_step1": bool(args.eos_step1),
            "eos_at_steps": args.eos_at_steps or None,
            "mean_forced_answer_len": mean_forced_len,
            "int8_cross_kv": bool(args.int8_cross_kv),
            "int8_kv_layout": args.int8_kv_layout,
            "int8_encoder_ffn": bool(args.int8_ffn),
            "int8_encoder_attn": bool(args.int8_attn),
            "int8_decoder_step": bool(args.int8_decoder),
            # the ensemble path takes no prefill_chunks
            "prefill_chunks": (None if args.ensembles
                               else args.prefill_chunks),
            "ensembles": args.ensembles or None,
            "members_per_call": (
                args.members_per_call if args.ensembles else None),
        },
        "device": device_info(dev),
    }


def main(argv: Optional[List[str]] = None) -> None:
    print(json.dumps(bench(build_parser().parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
