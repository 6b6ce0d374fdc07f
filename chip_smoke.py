#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

    python3 chip_smoke.py

Phases, one output line each (the kernel build also prints the compiler's
register / shared-memory / spill report):

  env        the card's name and power limit (nvidia-smi), torch, CUDA, nvcc
  build      compile every kernel of the main path from csrc/ with nvcc
  attention  the t5_attention_core kernel against its plain PyTorch version
             at the main path's shapes (B=32, L=557, H=32, dh=64, bf16), and
             its time beside the plain version's, one PyTorch library call's
             and the card's bound
  reference  the encoder at full width on a small input: kernel path against
             the plain materialised-bias path
  generate   VC-T0 few-shot generation at full T0-3B width and depth (random
             weights from a seed): 32 prompts of 512 tokens with 5 sentinels,
             an mlp mapper, 20 greedy tokens, run twice; the kernel must be
             launched once per encoder layer in each run
  breakdown  the same call's layers timed one by one (mapper and splice,
             encoder, greedy decode), each ending in a synchronize
  profile    one more call under torch.profiler: the device time of the
             call's kernels, their share of the timed (unprofiled) call's
             wall time, and the kernels that take the most device time

Then a line listing every kernel of the path with its launches and times,
and last the line {"ok": true, "device": {...}}. Any failed check exits
non-zero before that line; without a CUDA card it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from explicit_alignment_for_vqa_tasks_tpu_torch import kernels  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as t5_lib  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models.mappers import (  # noqa: E402
    MapperConfig,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.decoding import (  # noqa: E402
    greedy_decode_t5,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models.vct0 import (  # noqa: E402
    VCT0Config,
    VCT0Model,
    init_vct0_params,
    project_prefix,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.fused_attention_block import (  # noqa: E402
    t5_attention_core,
    t5_attention_core_plain,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.prefix_splice import (  # noqa: E402
    T5_SENTINEL_BASE,
    insert_prefix_into_input,
    splice_output_length,
)

SEED = 0
BATCH = 32
PROMPT_LEN = 512
NUM_SHOTS = 4                 # 4 shots + the question = 5 sentinels
PREFIX_LENGTH = 10
PREFIX_SIZE = 768             # CLIP ViT-L/14 embedding width
MAX_NEW_TOKENS = 20
# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
KERNEL_ATOL = KERNEL_RTOL = 8e-3   # one bf16 ulp of outputs below 2
REFERENCE_REL_ERR = 2e-2           # a few bf16 roundings over 2 layers

KERNEL_SOURCE = "explicit_alignment_for_vqa_tasks_tpu_torch/csrc/t5_attention_core.cu"
KERNEL_REPLACES = "explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py:1168"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc,
         python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = kernels.build(ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            print(f"[nvcc {name}] {line}", flush=True)
    emit("build", seconds=seconds, kernels=sorted(logs))


def phase_attention(gen: torch.Generator) -> dict:
    cfg = t5_lib.T5Config.t0_3b()
    batch, heads, head_dim = BATCH, cfg.num_heads, cfg.d_kv
    length = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    width = heads * head_dim
    dev = gen.device

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    q = randn(batch, length, width, scale=0.5).bfloat16()
    k = randn(batch, length, width, scale=0.5).bfloat16()
    v = (torch.rand((batch, length, width), generator=gen, device=dev)
         .mul_(2).sub_(1).bfloat16())
    bias = randn(heads, length, length, scale=0.5)
    mask = torch.ones((batch, length), dtype=torch.int32, device=dev)
    for b in range(1, batch, 4):          # padded tails of several lengths
        mask[b, length - 40 - 3 * b:] = 0
    mask[batch - 1] = 0                   # one fully masked row

    got = t5_attention_core(q, k, v, bias, mask, heads)
    torch.cuda.synchronize()
    want = t5_attention_core_plain(q, k, v, bias, mask, heads)
    err = (got.float() - want.float()).abs()
    max_abs_err = err.max().item()
    check(torch.isfinite(got.float()).all().item(), "kernel output not finite")
    check(max_abs_err <= KERNEL_ATOL,
          f"kernel differs from plain version by {max_abs_err}")
    check(bool((err <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all()),
          "kernel outside atol/rtol 8e-3 of the plain version")
    uniform = v[batch - 1].float().mean(dim=0)
    check(torch.allclose(got[batch - 1].float(), uniform.expand(length, -1),
                         atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
          "fully masked row is not the uniform mean of v")
    del want, err

    kernel_ms = cuda_ms(lambda: t5_attention_core(q, k, v, bias, mask, heads),
                        iters=20)
    plain_ms = cuda_ms(
        lambda: t5_attention_core_plain(q, k, v, bias, mask, heads), iters=3,
        warmup=1)
    # yardstick only: one PyTorch call computing the same function
    q4, k4, v4 = (x.view(batch, length, heads, head_dim).transpose(1, 2)
                  for x in (q, k, v))
    lib_mask = (bias[None] + torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
                ).bfloat16()
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=lib_mask, scale=1.0), iters=10)
    del lib_mask

    bytes_moved = 4 * q.numel() * q.element_size() + bias.numel() * 4 \
        + mask.numel() * 4
    flops = 4 * batch * heads * length * length * head_dim
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    result = dict(
        shape=dict(B=batch, L=length, H=heads, dh=head_dim),
        max_abs_err=max_abs_err, ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=max(bytes_ms, flops_ms),
        bound_by="bytes" if bytes_ms >= flops_ms else "operations",
        bytes=bytes_moved, flops=flops,
    )
    emit("attention", kernel_ms=kernel_ms, **{
        k: v for k, v in result.items() if k != "ms"})
    return result


def make_prompts(cfg: VCT0Config, dev: torch.device):
    """32 prompts of 512 tokens, each with NUM_SHOTS + 1 sentinels
    (<extra_id_0> ... left to right); every fourth row right-padded."""
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(3, 32000, (BATCH, PROMPT_LEN)).astype(np.int32)
    mask = np.ones((BATCH, PROMPT_LEN), np.int32)
    for b in range(BATCH):
        valid = PROMPT_LEN - (60 + 2 * b if b % 4 == 3 else 0)
        tokens[b, valid:] = cfg.lm.pad_token_id
        mask[b, valid:] = 0
        spots = np.sort(rng.choice(valid - 1, NUM_SHOTS + 1, replace=False))
        for g, j in enumerate(spots):
            tokens[b, j] = cfg.sentinel_base - g
    prefix = torch.from_numpy(
        rng.standard_normal((BATCH, NUM_SHOTS + 1, PREFIX_SIZE))
        .astype(np.float32))
    return (prefix.to(dev), torch.from_numpy(tokens).to(dev),
            torch.from_numpy(mask).to(dev))


def phase_reference(model: VCT0Model, prefix, tokens, mask) -> None:
    """Full width, 2 layers, 2 prompts: the encoder through the kernel
    against the plain materialised-bias path on the same inputs."""
    cfg, lm = model.cfg, model.params["lm"]
    with torch.inference_mode():
        text = t5_lib.embed_tokens(lm, cfg.lm, tokens[:2])
        proj = project_prefix(cfg, model.params["mapper"], prefix[:2])
        joint, joint_mask = insert_prefix_into_input(
            tokens[:2], text, proj.to(text.dtype), mask[:2],
            prefix_length=cfg.prefix_length, num_prefixes=NUM_SHOTS + 1,
            base_id=cfg.sentinel_base)
        outs = {}
        for fused in (True, False):
            lm_cfg = dataclasses.replace(cfg.lm, num_encoder_layers=2,
                                         fused_encoder_attention=fused)
            outs[fused] = t5_lib.t5_encode(lm, lm_cfg, inputs_embeds=joint,
                                           attention_mask=joint_mask).float()
    valid = joint_mask.bool()
    a, b = outs[True][valid], outs[False][valid]
    rel_err = ((a - b).norm() / b.norm()).item()
    check(torch.isfinite(a).all().item(), "kernel-path encoder not finite")
    check(rel_err <= REFERENCE_REL_ERR,
          f"kernel-path encoder differs from plain path: rel err {rel_err}")
    emit("reference", layers=2, batch=2, length=joint.shape[1],
         rel_err=rel_err, limit=REFERENCE_REL_ERR)


def phase_generate(model: VCT0Model, prefix, tokens, mask) -> dict:
    cfg = model.cfg
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t5_attention_core.launches = 0
        t0 = time.perf_counter()
        out_tokens, logprobs = model.generate(
            prefix, tokens, mask, num_shots=NUM_SHOTS,
            max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(dict(tokens=out_tokens, logprobs=logprobs, wall_s=wall,
                         launches=t5_attention_core.launches,
                         peak_bytes=torch.cuda.max_memory_allocated()))
    first, second = runs
    for run in runs:
        check(run["launches"] == cfg.lm.num_encoder_layers,
              f"t5_attention_core launched {run['launches']} times, "
              f"expected {cfg.lm.num_encoder_layers}")
    out_tokens, logprobs = second["tokens"], second["logprobs"]
    check(tuple(out_tokens.shape) == (BATCH, MAX_NEW_TOKENS),
          f"tokens shape {tuple(out_tokens.shape)}")
    check(torch.equal(first["tokens"], out_tokens),
          "the two runs generated different tokens")
    check(bool(((out_tokens >= 0) & (out_tokens < cfg.lm.vocab_size)).all()),
          "token outside the vocabulary")
    check(bool(torch.isfinite(logprobs).all()), "log-prob not finite")
    check(bool((logprobs <= 0).all()), "log-prob above 0")
    scores = model.score_sequences(out_tokens, logprobs)
    check(bool(torch.isfinite(scores).all()), "sequence score not finite")
    result = dict(
        batch=BATCH, encoder_tokens=int(splice_output_length(
            PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)),
        new_tokens=MAX_NEW_TOKENS, wall_s=second["wall_s"],
        first_wall_s=first["wall_s"],
        prompts_per_s=BATCH / second["wall_s"],
        peak_mem_gb=second["peak_bytes"] / 1e9,
        launches_per_call=[r["launches"] for r in runs],
        rows_with_eos=int((out_tokens == cfg.lm.eos_token_id).any(1).sum()),
        first_tokens=out_tokens[0, :5].tolist(),
    )
    emit("generate", **result)
    return result


def phase_breakdown(model: VCT0Model, prefix, tokens, mask) -> None:
    cfg, lm = model.cfg, model.params["lm"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def splice():
        text = t5_lib.embed_tokens(lm, cfg.lm, tokens)
        proj = project_prefix(cfg, model.params["mapper"], prefix)
        return insert_prefix_into_input(
            tokens, text, proj.to(text.dtype), mask,
            prefix_length=cfg.prefix_length, num_prefixes=NUM_SHOTS + 1,
            base_id=cfg.sentinel_base)

    with torch.inference_mode():
        (joint, joint_mask), splice_s = timed(splice)
        hidden, encode_s = timed(lambda: t5_lib.t5_encode(
            lm, cfg.lm, inputs_embeds=joint, attention_mask=joint_mask))
        _, decode_s = timed(lambda: greedy_decode_t5(
            lm, cfg.lm, hidden, joint_mask, MAX_NEW_TOKENS))
    emit("breakdown", mapper_splice_s=splice_s, encode_s=encode_s,
         decode_s=decode_s, decode_step_ms=decode_s / MAX_NEW_TOKENS * 1e3)


def phase_profile(model: VCT0Model, prefix, tokens, mask,
                  timed_wall_s: float) -> None:
    """The profiler slows the host, not the kernels, so the busy share is
    the kernels' device time over the unprofiled call's wall time."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        model.generate(prefix, tokens, mask, num_shots=NUM_SHOTS,
                       max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    kernels_us = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            kernels_us[event.name] = (kernels_us.get(event.name, 0.0)
                                      + event.time_range.elapsed_us())
    busy_s = sum(kernels_us.values()) / 1e6
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:6]
    emit("profile", profiled_wall_s=profiled_wall, device_busy_s=busy_s,
         timed_wall_s=timed_wall_s,
         busy_share=busy_s / timed_wall_s if busy_s else None,
         device_events=len(kernels_us),
         top_kernels_ms=[[name[:60], us / 1e3] for name, us in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if kernels.CSRC_DIR.parent.parent != REPO:
        print(f"chip_smoke: the port was imported from {kernels.CSRC_DIR.parent}, "
              f"not from this checkout ({REPO})", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    phase_env()
    phase_build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    attention = phase_attention(gen)

    cfg = VCT0Config(
        lm=t5_lib.T5Config.t0_3b(fused_encoder_attention=True),
        mapper=MapperConfig(mapping_type="mlp", prefix_size=PREFIX_SIZE,
                            d_model=2048, prefix_length=PREFIX_LENGTH,
                            clip_length=PREFIX_LENGTH),
        sentinel_base=T5_SENTINEL_BASE,
    )
    t0 = time.perf_counter()
    model = VCT0Model(cfg, init_vct0_params(cfg, seed=SEED, device=dev))
    torch.cuda.synchronize()
    emit("init", seconds=time.perf_counter() - t0,
         params_gb=torch.cuda.memory_allocated() / 1e9)
    prefix, tokens, mask = make_prompts(cfg, dev)
    phase_reference(model, prefix, tokens, mask)
    generate = phase_generate(model, prefix, tokens, mask)
    phase_breakdown(model, prefix, tokens, mask)
    phase_profile(model, prefix, tokens, mask, generate["wall_s"])

    print(json.dumps({"kernels": [{
        "name": "t5_attention_core", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": generate["launches_per_call"][-1],
        "max_abs_err": attention["max_abs_err"], "ms": attention["ms"],
        "plain_ms": attention["plain_ms"], "bound_ms": attention["bound_ms"],
        "bound_by": attention["bound_by"],
        "library_ms": attention["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
