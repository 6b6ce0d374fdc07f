"""Mapping-network training throughput of the port, in examples/s on one card.

Counterpart of the root ``bench_train.py`` (the JAX package's): one train
step is the mapper forward, the frozen LM's forward and its backward into
the mapper, and an AdamW update (lr 1e-4, optax ``adamw``'s defaults), on
random weights (seed 0) at the same defaults and flags:

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.bench_train \\
        [--model vct0|clipcap] [--batch 32] [--caption_len 32] [--steps 10] \\
        [--fused_attention 1]

``--model vct0``: T0-3B with the ``mlp`` mapper (768 -> 10 prefix
positions), the captioning loss ``vct0_caption_loss``; ``--fused_attention
1`` runs the encoder attention through the ``t5_attention_core`` kernel
(its gradient through ``t5_attention_core_vjp``'s twin). ``--model
clipcap``: GPT-2 small with the mapper (512 -> 10), ``clipcap_loss``;
``--fused_attention 1`` runs each block through the ``fused_gpt2_block``
kernel. After a first step, ``--steps`` steps are timed by the host clock,
each clock read after ``torch.cuda.synchronize()``. One JSON line goes to
stdout with the JAX bench's metric name and ``config`` keys, plus the
card's name and power limit. ``bench`` takes the parsed flags, the base LM
config and the device, so that a test can run it at a small width on the
CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.clipcap import ClipCapConfig, clipcap_loss, init_clipcap_params
from ..models.gpt2 import GPT2Config
from ..models.mappers import MapperConfig
from ..models.t5 import T5Config
from ..models.vct0 import VCT0Config, init_vct0_params, vct0_caption_loss
from ..trainers.optimization import tree_leaves
from .bench_generate import device_info

METRICS = {
    "vct0": "vct0_3b_mapper_train_examples_per_sec_per_chip",
    "clipcap": "clipcap_gpt2_mapper_train_examples_per_sec_per_chip",
}
PREFIX_SIZES = {"vct0": 768, "clipcap": 512}   # CLIP ViT-L/14, ViT-B/32
PREFIX_LENGTH = 10
LR = 1e-4
OPTAX_ADAMW_WEIGHT_DECAY = 1e-4                # optax.adamw's default


def build_parser() -> argparse.ArgumentParser:
    """The JAX bench's flags, with the same names and defaults."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--caption_len", type=int, default=32)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--fused_attention", type=int, default=0,
                        help="vct0: the encoder attention kernel; clipcap: "
                        "the fused GPT-2 block kernel (both differentiable "
                        "through their autograd forms)")
    parser.add_argument("--model", choices=["vct0", "clipcap"],
                        default="vct0")
    return parser


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def clock(dev: torch.device) -> float:
    """The host clock once the card has finished what was queued (a CUDA
    launch returns before its work is done)."""
    synchronize(dev)
    return time.perf_counter()


def _model(args: argparse.Namespace, base: Any, dev: torch.device):
    """(loss of the mapper params, the mapper params, config keys)."""
    fused = bool(args.fused_attention)
    mapper = dict(prefix_size=PREFIX_SIZES[args.model],
                  prefix_length=PREFIX_LENGTH, clip_length=PREFIX_LENGTH)
    rng = np.random.default_rng(0)
    B, L = args.batch, args.caption_len
    prefix = torch.from_numpy(rng.standard_normal(
        (B, PREFIX_SIZES[args.model])).astype(np.float32)).to(dev)
    if args.model == "vct0":
        lm = dataclasses.replace(base or T5Config.t0_3b(),
                                 dtype=torch.bfloat16,
                                 fused_encoder_attention=fused)
        cfg = VCT0Config(lm=lm, mapper=MapperConfig(d_model=lm.d_model,
                                                    **mapper))
        params = init_vct0_params(cfg, seed=0, device=dev,
                                  param_dtype=torch.bfloat16)
        labels = torch.from_numpy(rng.integers(
            2, min(30000, lm.vocab_size), size=(B, L)).astype(np.int32)).to(dev)

        def loss(mapper_params):
            return vct0_caption_loss(mapper_params, params["lm"], cfg, prefix,
                                     labels)
        keys = {"fused_attention": fused}
    else:
        lm = dataclasses.replace(base or GPT2Config.gpt2_small(),
                                 dtype=torch.bfloat16, fused_block=fused)
        cfg = ClipCapConfig(lm=lm, mapper=MapperConfig(d_model=lm.d_model,
                                                       **mapper),
                            freeze_lm=True)
        params = init_clipcap_params(cfg, seed=0, device=dev,
                                     param_dtype=torch.bfloat16)
        ids = torch.from_numpy(rng.integers(
            2, min(50000, lm.vocab_size), size=(B, L)).astype(np.int32)).to(dev)
        mask = torch.ones((B, L), dtype=torch.int32, device=dev)

        def loss(mapper_params):
            return clipcap_loss(mapper_params, params["lm"], cfg, prefix, ids,
                                mask, ids)
        keys = {"fused_block": fused}
    return loss, params["mapper"], keys


def bench(args: argparse.Namespace, base: Any = None,
          device: DeviceLike = None) -> dict:
    """Build the model and time ``args.steps`` train steps after a first
    one; returns the result line's fields. ``base`` is the LM config
    (T0-3B or GPT-2 small by default)."""
    dev = resolve_device(device)
    print(f"device: {dev}", file=sys.stderr)
    loss_fn, mapper, keys = _model(args, base, dev)
    leaves = tree_leaves(mapper)
    for tensor in leaves:
        tensor.requires_grad_(True)
    optimizer = torch.optim.AdamW(leaves, lr=LR, betas=(0.9, 0.999),
                                  eps=1e-8,
                                  weight_decay=OPTAX_ADAMW_WEIGHT_DECAY)

    def step() -> torch.Tensor:
        loss = loss_fn(mapper)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    t0 = clock(dev)
    loss = step()
    first_s = clock(dev) - t0
    print(f"first step: {first_s:.3f}s loss={float(loss):.3f}",
          file=sys.stderr)
    t0 = clock(dev)
    for _ in range(args.steps):
        loss = step()
    dt = clock(dev) - t0
    return {
        "metric": METRICS[args.model],
        "value": round(args.batch * args.steps / dt, 2),
        "unit": "examples/s",
        "config": {"batch": args.batch, "caption_len": args.caption_len,
                   "prefix_length": PREFIX_LENGTH,
                   "final_loss": round(float(loss), 3), **keys},
        "step_s": dt / args.steps,
        "first_step_s": first_s,
        "device": device_info(dev),
    }


def main(argv: Optional[List[str]] = None) -> None:
    print(json.dumps(bench(build_parser().parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
