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
  int8_kernels
             the int8 encoder kernels (fused_t5_ln_qkv_q8,
             fused_oproj_residual_q8, fused_t5_ffn_q8) against their plain
             versions at the int8 path's shapes (M = 32 x 557 rows, D = 2048,
             F = 5120, 8 groups, weights from the port's quantizer), with
             kernel, plain and torch._int_mm (GEMMs only) times and bounds
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
  generate_int8
             the int8 bulk-eval configuration (int8_encoder_ffn and
             int8_encoder_attn) on the same weights and prompts: SmoothQuant
             calibration on that batch, generate twice (each of the four
             encoder kernels launched once per layer in each run), its
             encode / decode breakdown and profile, the cosine of the int8
             encoder's output against the bf16 kernel path's, and the two
             configurations' generate calls timed in turns
  decode_attention
             the cross_attention_decode kernel against its plain version at
             the decode step's shapes (24 stacked layers of B=32, L=557,
             D=2048 bf16 caches, layer 7), with kernel, plain,
             scaled_dot_product_attention and bound times
  t5_ffn     the fused_t5_ffn kernel against its plain version at the
             encoder's shapes (M = 32 x 557 rows, D = 2048, F = 5120,
             gated), with kernel, plain, bound times and the unfused bf16
             FFN's (three cuBLAS matmuls, gelu and gate) as the yardstick
  generate_fused
             the configuration with every fused kernel (fused_encoder_attention,
             fused_encoder_ffn, fused_decode_attention) on the same weights
             and prompts: generate twice (t5_attention_core and fused_t5_ffn
             24 launches, cross_attention_decode 24 per decode step run),
             its breakdown and profile, its tokens' agreement with the
             default path's (recorded, not gated), and the two
             configurations' calls timed in turns (bf16, fused, fused, bf16)
  generate_int8_all
             every int8 opt-in of base_env.jsonnet (int8_encoder_ffn,
             int8_encoder_attn, int8_cross_kv at the auto layout, which is
             unmerged at B=32, int8_decoder_step) with
             fused_encoder_attention: calibration and quantization (the
             decoder step W8A16, its bf16 weights dropped), generate twice,
             launches, peak memory, the params' size, breakdown and
             profile
  kv_layouts one decode step at full width and 2 decoder layers for each
             int8 cross-KV layout: unmerged and merged logits bit-equal,
             transposed close to them, each layout's cache bytes at rest
  vit_kernels
             the CLIP ViT split3 kernels (fused_ln_qkv, attention_core_oproj,
             fused_mlp_block) against their plain versions at ViT-L/14@336
             widths on 16 images (L = 577, D = 1024, 16 heads, F = 4096),
             then timed at the image encoder's batch of 256 beside the plain
             version, the bound and a library yardstick (layer_norm and
             cuBLAS matmuls; scaled_dot_product_attention)
  vit_q8_kernels
             the int8 ViT kernels (fused_qkv_q8, attention_core with and
             without fast_exp, fused_mlp_block_q8) against their plain
             versions at ViT-L/14@336 widths on 16 and on 256 images
             (weights from the port's quantize_vision_blocks, which must
             give the same codes and scales on the card as on the CPU),
             timed at 256 beside the plain version, the bound and a library
             yardstick (torch._int_mm, GEMMs only; scaled_dot_product_attention)
  clip_encode
             ClipImageEncoder at ViT-L/14@336, batch 256, random bf16 weights
             from a seed and random normalised images: the default (plain)
             path, fused_block (the three split3 kernels) and int8 (the
             quantization timed once; fused_qkv_q8, attention_core and
             fused_mlp_block_q8), each called twice with 24 launches of each
             of its kernels per call and none of the others', with images/s,
             peak memory, the device's busy share, the calls in turns and
             the fused and int8 paths' per-row cosines against the default
             path's; one split_fe encode at 2 layers (attention_core with
             fast_exp and fused_mlp_block, 2 launches each) against the
             default path at that depth; one whole and one whole_dd encode
             at 2 layers (fused_vit_block, 2 launches each) against the
             split3 path at that depth; and one ClipTextEncoder call at
             CLIPTextConfig width (B = 512, L = 77)
  t5_quantizers
             the T5 int8 weight quantizers (_quant_stacked_i8, and through
             it quantize_encoder_ffn / _attn and quantize_decoder_step) at
             T0-3B widths and 2 layers: the same codes and scales on the card
             as on the CPU, bit for bit
  vit_short_kernels
             the ViT-B/32 whole-block kernels (fused_vit_block in its three
             softmax orders, fused_vit_block_q8 on weights from
             quantize_vision_blocks, fused_attention_block) against their
             plain versions on 16 and on 1024 images (L = 50, D = 768, 12
             heads, F = 3072), timed at 1024 beside the plain version, the
             bound and a library yardstick (the unfused bf16 block;
             torch._int_mm, GEMMs only; fp32 matmuls and
             scaled_dot_product_attention)
  clip_encode_b32
             ClipImageEncoder at ViT-B/32 (12 layers), batch 1024, random
             bf16 weights from a seed and random normalised images: the
             default path, fused (fused_block with fast_attention and
             fused_attention, as the JAX bench builds it: fused_vit_block),
             int8 (fused_vit_block_q8) and fused_attention
             (fused_attention_block), each called twice with 12 launches of
             its kernel per call and none of the others', with images/s,
             peak memory, the device's busy share, the calls in turns and
             each path's per-row cosines against the default path's

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
from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as clip_lib  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import clipcap as clipcap_lib  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import gpt2 as gpt2_lib  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as t5_lib  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models.mappers import (  # noqa: E402
    MapperConfig,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.attention import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.decoding import (  # noqa: E402
    greedy_decode_gpt2,
    greedy_decode_t5,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models.vct0 import (  # noqa: E402
    VCT0Config,
    VCT0Model,
    init_vct0_params,
    project_prefix,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.decode_attention import (  # noqa: E402
    cross_attention_decode,
    cross_attention_decode_plain,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.fused_attention_block import (  # noqa: E402
    GPT2_BLOCK_KEYS,
    attention_core,
    attention_core_oproj,
    attention_core_oproj_plain,
    attention_core_plain,
    fused_ln_qkv,
    fused_ln_qkv_plain,
    fused_mlp_block,
    fused_mlp_block_plain,
    fused_mlp_block_q8,
    fused_mlp_block_q8_plain,
    fused_oproj_residual_q8,
    fused_oproj_residual_q8_plain,
    fused_attention_block,
    fused_attention_block_plain,
    fused_gpt2_block,
    fused_gpt2_block_plain,
    fused_qkv_q8,
    fused_qkv_q8_plain,
    fused_t5_ffn,
    fused_t5_ffn_plain,
    fused_t5_ffn_q8,
    fused_t5_ffn_q8_plain,
    fused_t5_ln_qkv_q8,
    fused_t5_ln_qkv_q8_plain,
    fused_vit_block,
    fused_vit_block_plain,
    fused_vit_block_q8,
    fused_vit_block_q8_plain,
    gpt2_block_group,
    t5_attention_core,
    t5_attention_core_plain,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.prefix_splice import (  # noqa: E402
    T5_SENTINEL_BASE,
    insert_prefix_into_input,
    splice_output_length,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools.clip_encoder import (  # noqa: E402
    ClipImageEncoder,
    ClipTextEncoder,
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
INT8_OP_PER_S = 1979e12
FP32_FLOP_PER_S = 67e12           # outside the tensor cores
KERNEL_ATOL = KERNEL_RTOL = 8e-3   # one bf16 ulp of outputs below 2
REFERENCE_REL_ERR = 2e-2           # a few bf16 roundings over 2 layers
# int8 kernel against plain: two bf16 ulps, plus room for a rare activation
# code flipped by the norm's sum order
Q8_REL_FROBENIUS = 2e-3
Q8_ELEMENT_TOL = 1.6e-2            # x |want| + x rms(want)
INT8_GROUPS = 8
INT8_COSINE_FLOOR = 0.95           # a sanity floor; the value is recorded
DECODE_LAYER = 7                   # the cache layer the decode kernel reads
# transposed int8 cross-KV logits against unmerged: the same products
# summed in another order (rel. Frobenius over the logits)
LAYOUT_REL_ERR = 1e-3
VIT_CHECK_BATCH = 16               # images of the ragged-edge value check
CLIP_BATCH = 256                   # the image encoder's batch
CLIP_COSINE_FLOOR = 0.99           # fused or int8 against default, per row
SPLIT_FE_LAYERS = 2                # depth of the split_fe and whole encodes
TEXT_BATCH = 512                   # ClipTextEncoder's batch
B32_BATCH = 1024                   # the JAX bench's ViT-B/32 batch
T5_QUANT_LAYERS = 2                # depth of the T5 quantizers' card = CPU check
# ClipCap: configs/vqa2/clip_cap.jsonnet's model_args (GPT-2 small, the mlp
# mapper from ViT-B/32's 512-d embeddings to 10 prefix positions)
CLIPCAP_MODEL_ARGS = {"prefix_length": 10, "clip_length": 10,
                      "prefix_size": 512, "mapping_type": "mlp",
                      "model_version": "gpt2"}
CLIPCAP_BATCH = 32                 # the config's train.batch_size
CLIPCAP_PROMPT = 32                # generate's longest prompt, in tokens
CLIPCAP_LOSS_TOKENS = 54           # + 10 prefix = 64 positions: the kernel
CLIPCAP_BUCKET_TOKENS = 128        # the shipped 128-token bucket: 138, none
CLIPCAP_LOSS_REL = 1e-2            # fused against unfused loss, relative
PALLAS_COSINE_FLOOR = 0.999        # use_pallas against default, per row

PORT_CSRC = "explicit_alignment_for_vqa_tasks_tpu_torch/csrc/"
JAX_OPS = "explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py"
# kernel name -> (source, pallas_call it replaces)
KERNELS = {
    "t5_attention_core": (PORT_CSRC + "t5_attention_core.cu",
                          JAX_OPS + ":1168"),
    "fused_t5_ln_qkv_q8": (PORT_CSRC + "int8_encoder.cu", JAX_OPS + ":1666"),
    "fused_oproj_residual_q8": (PORT_CSRC + "int8_encoder.cu",
                                JAX_OPS + ":1715"),
    "fused_t5_ffn_q8": (PORT_CSRC + "int8_encoder.cu", JAX_OPS + ":1595"),
    "cross_attention_decode": (
        PORT_CSRC + "cross_attention_decode.cu",
        "explicit_alignment_for_vqa_tasks_tpu/ops/decode_attention.py:134"),
    "fused_t5_ffn": (PORT_CSRC + "t5_ffn.cu", JAX_OPS + ":671"),
    "fused_ln_qkv": (PORT_CSRC + "vit_block.cu", JAX_OPS + ":290"),
    "attention_core_oproj": (PORT_CSRC + "vit_block.cu", JAX_OPS + ":366"),
    "fused_mlp_block": (PORT_CSRC + "vit_block.cu", JAX_OPS + ":445"),
    "fused_qkv_q8": (PORT_CSRC + "vit_block_q8.cu", JAX_OPS + ":584"),
    "attention_core": (PORT_CSRC + "vit_block.cu", JAX_OPS + ":225"),
    "fused_mlp_block_q8": (PORT_CSRC + "vit_block_q8.cu", JAX_OPS + ":516"),
    "fused_vit_block": (PORT_CSRC + "vit_block.cu", JAX_OPS + ":1398"),
    "fused_vit_block_q8": (PORT_CSRC + "vit_block_q8.cu", JAX_OPS + ":810"),
    "fused_attention_block": (PORT_CSRC + "vit_block.cu", JAX_OPS + ":1452"),
    "fused_gpt2_block": (PORT_CSRC + "gpt2_block.cu", JAX_OPS + ":933"),
    "flash_attention": (
        PORT_CSRC + "flash_attention.cu",
        "explicit_alignment_for_vqa_tasks_tpu/ops/attention.py:142"),
}
PATH_KERNELS = (t5_attention_core, fused_t5_ln_qkv_q8,
                fused_oproj_residual_q8, fused_t5_ffn_q8,
                cross_attention_decode, fused_t5_ffn,
                fused_ln_qkv, attention_core_oproj, fused_mlp_block,
                fused_qkv_q8, attention_core, fused_mlp_block_q8,
                fused_vit_block, fused_vit_block_q8, fused_attention_block,
                fused_gpt2_block, flash_attention)
VIT_KERNELS = (fused_ln_qkv, attention_core_oproj, fused_mlp_block)
VIT_Q8_KERNELS = (fused_qkv_q8, attention_core, fused_mlp_block_q8)


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
    result = dict(
        shape=dict(B=batch, L=length, H=heads, dh=head_dim),
        max_abs_err=max_abs_err, ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, **bound(bytes_moved, flops, BF16_FLOP_PER_S),
    )
    emit("attention", kernel_ms=kernel_ms, **{
        k: v for k, v in result.items() if k != "ms"})
    return result


def bound(bytes_moved: float, ops: float, ops_per_s: float) -> dict:
    return bound_mixed(bytes_moved, [(ops, ops_per_s)])


def bound_mixed(bytes_moved: float, parts) -> dict:
    """The least time for ``bytes_moved`` and the (operations, peak rate)
    ``parts``, each part at its own type's peak, one after the other."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = sum(ops / ops_per_s for ops, ops_per_s in parts) * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=bytes_moved, ops=sum(ops for ops, _ in parts))


def compare_q8(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Kernel against plain: max abs error, relative Frobenius error, the
    share of elements beyond one bf16 ulp of the plain value; fails unless
    both tolerances hold."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rel = ((got - want).norm() / want.norm()).item()
    rms = want.square().mean().sqrt()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    check(bool(torch.isfinite(got).all()), "int8 kernel output not finite")
    check(rel <= Q8_REL_FROBENIUS,
          f"int8 kernel's relative Frobenius error {rel} > {Q8_REL_FROBENIUS}")
    check(bool((err <= Q8_ELEMENT_TOL * want.abs()
                + Q8_ELEMENT_TOL * rms).all()),
          f"int8 kernel outside {Q8_ELEMENT_TOL} x (|want| + rms(want))")
    return dict(max_abs_err=err.max().item(), rel_frobenius=rel,
                beyond_one_ulp=(err > ulp).float().mean().item())


def check_against_plain(name: str, fn, plain, args, batch: int,
                        int8: bool = False) -> dict:
    """The kernel against its plain version on the same inputs: each output
    finite and within KERNEL_ATOL + KERNEL_RTOL |want| (int8 kernels:
    compare_q8's rule); the largest error, the elements that differ."""
    got = fn(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    out = dict(max_abs_err=0.0, differing=0, elements=0)
    for g, p in zip(got, want):
        if int8:
            out["rel_frobenius"] = max(out.get("rel_frobenius", 0.0),
                                       compare_q8(g, p)["rel_frobenius"])
        g, p = g.float(), p.float()
        err = (g - p).abs()
        check(bool(torch.isfinite(g).all()),
              f"{name} at B={batch}: output not finite")
        if not int8:
            check(bool((err <= KERNEL_ATOL + KERNEL_RTOL * p.abs()).all()),
                  f"{name} at B={batch} outside atol/rtol 8e-3 of the "
                  f"plain version (max abs err {err.max().item()})")
        out["max_abs_err"] = max(out["max_abs_err"], err.max().item())
        out["differing"] += int((err > 0).sum())
        out["elements"] += err.numel()
        del g, p, err
    del got, want
    torch.cuda.empty_cache()
    return out


def phase_int8_kernels(gen: torch.Generator) -> dict:
    """Each int8 kernel against its plain version at the int8 path's
    shapes, on weights from the port's quantizer."""
    cfg = t5_lib.T5Config.t0_3b()
    length = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    d_model, inner, d_ff = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    rows = BATCH * length
    dev = gen.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    def quant(k, n):
        q, s = t5_lib._quant_stacked_i8(randn(1, k, n, scale=k ** -0.5),
                                        INT8_GROUPS)
        return q[0], s[0]

    def codes(k):  # activation codes for the library yardstick
        return torch.randint(-127, 128, (rows, k), generator=gen, device=dev,
                             dtype=torch.int8)

    x = randn(BATCH, length, d_model, scale=2.0).bfloat16()
    attn = randn(BATCH, length, inner).bfloat16()
    lnw = (1 + 0.1 * randn(d_model)).bfloat16()
    qkv_w = [quant(d_model, inner) for _ in range(3)]
    o_w = quant(inner, d_model)
    ffn_w = [quant(d_model, d_ff), quant(d_model, d_ff), quant(d_ff, d_model)]
    act = rows * d_model * 2               # one bf16 (M, D) activation
    cases = {
        "fused_t5_ln_qkv_q8": dict(
            fn=fused_t5_ln_qkv_q8, plain=fused_t5_ln_qkv_q8_plain,
            args=(x, lnw, *[t for w in qkv_w for t in w]),
            gemms=[(d_model, w) for w, _ in qkv_w],
            bytes=act + d_model * 2 + 3 * rows * inner * 2
            + sum(w.numel() + s.numel() * 4 for w, s in qkv_w),
            ops=3 * 2 * rows * d_model * inner),
        "fused_oproj_residual_q8": dict(
            fn=fused_oproj_residual_q8, plain=fused_oproj_residual_q8_plain,
            args=(x, attn, *o_w), gemms=[(inner, o_w[0])],
            bytes=2 * act + rows * inner * 2 + o_w[0].numel()
            + o_w[1].numel() * 4,
            ops=2 * rows * inner * d_model),
        "fused_t5_ffn_q8": dict(
            fn=fused_t5_ffn_q8, plain=fused_t5_ffn_q8_plain,
            args=(x, lnw, *[t for w in ffn_w for t in w]),
            gemms=[(d_model, ffn_w[0][0]), (d_model, ffn_w[1][0]),
                   (d_ff, ffn_w[2][0])],
            bytes=2 * act + d_model * 2
            + sum(w.numel() + s.numel() * 4 for w, s in ffn_w),
            ops=2 * rows * d_model * d_ff * 2 + 2 * rows * d_ff * d_model),
    }
    results = {}
    for name, case in cases.items():
        fn, plain, args = case["fn"], case["plain"], case["args"]
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = [compare_q8(g, w) for g, w in zip(got, want)]
        del got, want
        kernel_ms = cuda_ms(lambda: fn(*args), iters=20)
        plain_ms = cuda_ms(lambda: plain(*args), iters=3, warmup=1)
        # yardstick only: torch._int_mm of the same int8 products, GEMMs
        # alone (no norm, quantization, scales or epilogue), with the
        # weights column-major as cuBLASLt's int8 GEMM takes them (the
        # transpose is made before the timing), and as the port stores them
        lib_in = [(codes(k), w) for k, w in case["gemms"]]
        lib_col = [(a, w.t().contiguous().t()) for a, w in lib_in]
        library_ms = cuda_ms(
            lambda: [torch._int_mm(a, w) for a, w in lib_col], iters=10)
        library_row_major_ms = cuda_ms(
            lambda: [torch._int_mm(a, w) for a, w in lib_in], iters=10)
        del lib_in, lib_col
        results[name] = dict(
            shape=dict(M=rows, D=d_model, inner=inner, F=d_ff,
                       G=INT8_GROUPS),
            max_abs_err=max(e["max_abs_err"] for e in errs),
            rel_frobenius=max(e["rel_frobenius"] for e in errs),
            beyond_one_ulp=max(e["beyond_one_ulp"] for e in errs),
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            library="torch._int_mm, GEMMs only, column-major weights",
            library_row_major_ms=library_row_major_ms,
            **bound(case["bytes"], case["ops"], INT8_OP_PER_S))
        emit("int8_kernels", kernel=name, kernel_ms=kernel_ms, **{
            k: v for k, v in results[name].items() if k != "ms"})
    return results


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


def decode_steps_run(out_tokens: torch.Tensor, eos: int) -> int:
    """The decode steps greedy_decode_from_cache ran for these tokens: it
    stops after the step at which the last row emitted EOS."""
    has_eos = (out_tokens == eos).any(dim=1)
    if not bool(has_eos.all()):
        return out_tokens.shape[1]
    first_eos = (out_tokens == eos).float().argmax(dim=1)
    return int(first_eos.max()) + 1


def launches(**counts) -> dict:
    """Expected launches of every kernel of the path (0 unless named)."""
    return {fn.__name__: counts.get(fn.__name__, 0) for fn in PATH_KERNELS}


def phase_generate(model: VCT0Model, prefix, tokens, mask, expected,
                   phase: str = "generate") -> dict:
    """generate twice; every kernel count is set to 0 just before each call
    and read just after, and must equal ``expected(steps)`` (name ->
    launches), ``steps`` being the decode steps the call ran."""
    cfg = model.cfg
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in PATH_KERNELS:
            fn.launches = 0
        t0 = time.perf_counter()
        out_tokens, logprobs = model.generate(
            prefix, tokens, mask, num_shots=NUM_SHOTS,
            max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(dict(tokens=out_tokens, logprobs=logprobs, wall_s=wall,
                         launches={fn.__name__: fn.launches
                                   for fn in PATH_KERNELS},
                         peak_bytes=torch.cuda.max_memory_allocated(),
                         steps=decode_steps_run(out_tokens,
                                                cfg.lm.eos_token_id)))
    first, second = runs
    for run in runs:
        want = expected(run["steps"])
        check(run["launches"] == want,
              f"{phase}: kernels launched {run['launches']}, expected "
              f"{want}")
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
        decode_steps=[r["steps"] for r in runs],
        rows_with_eos=int((out_tokens == cfg.lm.eos_token_id).any(1).sum()),
        first_tokens=out_tokens[0, :5].tolist(),
    )
    emit(phase, **result)
    result["tokens"] = out_tokens
    return result


def phase_breakdown(model: VCT0Model, prefix, tokens, mask,
                    phase: str = "breakdown") -> dict:
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
    result = dict(mapper_splice_s=splice_s, encode_s=encode_s,
                  decode_s=decode_s,
                  decode_step_ms=decode_s / MAX_NEW_TOKENS * 1e3)
    emit(phase, **result)
    return result


def device_busy(fn, timed_wall_s: float, top: int = 10) -> dict:
    """One more call of fn under torch.profiler. The profiler slows the
    host, not the kernels, so the busy share is the kernels' device time
    over the unprofiled call's wall time."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    kernels_us = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            kernels_us[event.name] = (kernels_us.get(event.name, 0.0)
                                      + event.time_range.elapsed_us())
    busy_s = sum(kernels_us.values()) / 1e6
    largest = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:top]
    return dict(profiled_wall_s=profiled_wall, device_busy_s=busy_s,
                timed_wall_s=timed_wall_s,
                busy_share=busy_s / timed_wall_s if busy_s else None,
                device_events=len(kernels_us),
                top_kernels_ms=[[name[:90], us / 1e3]
                                for name, us in largest])


def phase_profile(model: VCT0Model, prefix, tokens, mask,
                  timed_wall_s: float, phase: str = "profile") -> None:
    emit(phase, **device_busy(
        lambda: model.generate(prefix, tokens, mask, num_shots=NUM_SHOTS,
                               max_new_tokens=MAX_NEW_TOKENS),
        timed_wall_s))


def generate_in_turns(models: dict, prefix, tokens, mask) -> dict:
    """Two configurations' generate calls in turns (a, b, b, a), since the
    decode's host-side time moves between calls of the same code."""
    a, b = models
    turns = {a: [], b: []}
    for name in (a, b, b, a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models[name].generate(prefix, tokens, mask, num_shots=NUM_SHOTS,
                              max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        turns[name].append(time.perf_counter() - t0)
    return turns


def phase_generate_int8(model: VCT0Model, prefix, tokens, mask,
                        bf16_encode_s: float) -> dict:
    """The int8 bulk-eval configuration on the bf16 model's weights and
    prompts: SmoothQuant calibration on that batch, generate twice, the
    breakdown, and the cosine of its encoder output against the bf16
    kernel path's on the same spliced input."""
    lm_cfg = dataclasses.replace(model.cfg.lm, int8_encoder_ffn=True,
                                 int8_encoder_attn=True)
    int8 = VCT0Model(dataclasses.replace(model.cfg, lm=lm_cfg),
                     dict(model.params))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = int8.calibrate_and_quantize_int8(
        [dict(prefix=prefix, question_tokens=tokens, question_mask=mask)],
        alpha=0.5)
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - t0
    check(all(bool(torch.isfinite(v).all()) for v in stats.values()),
          "calibration statistics not finite")
    emit("calibrate_int8", seconds=calibrate_s, alpha=0.5,
         groups=int(int8.params["lm"]["encoder"]["ffn_q8"]["wi_0_s"].shape[1]),
         params_gb=torch.cuda.memory_allocated() / 1e9)

    layers = lm_cfg.num_encoder_layers
    result = phase_generate(
        int8, prefix, tokens, mask,
        expected=lambda steps: launches(
            t5_attention_core=layers, fused_t5_ln_qkv_q8=layers,
            fused_oproj_residual_q8=layers, fused_t5_ffn_q8=layers),
        phase="generate_int8")
    breakdown = phase_breakdown(int8, prefix, tokens, mask,
                                phase="breakdown_int8")
    phase_profile(int8, prefix, tokens, mask, result["wall_s"],
                  phase="profile_int8")

    with torch.inference_mode():
        joint, joint_mask = int8.encoder_calibration_batch(prefix, tokens,
                                                           mask)
        outs = [t5_lib.t5_encode(m.params["lm"], m.cfg.lm,
                                 inputs_embeds=joint,
                                 attention_mask=joint_mask).double()
                for m in (model, int8)]
    valid = joint_mask.bool()
    a, b = outs[0][valid].flatten(), outs[1][valid].flatten()
    cosine = (a @ b / (a.norm() * b.norm())).item()
    check(cosine >= INT8_COSINE_FLOOR,
          f"int8 encoder output's cosine to bf16 {cosine} < "
          f"{INT8_COSINE_FLOOR}")
    turns = generate_in_turns({"bf16": model, "int8": int8}, prefix, tokens,
                              mask)
    emit("int8_vs_bf16", encoder_cosine=cosine, floor=INT8_COSINE_FLOOR,
         int8_encode_s=breakdown["encode_s"], bf16_encode_s=bf16_encode_s,
         encode_speedup=bf16_encode_s / breakdown["encode_s"],
         generate_s_in_turns=turns,
         prompts_per_s_in_turns={k: [BATCH / t for t in v]
                                 for k, v in turns.items()})
    return result


def phase_decode_attention(gen: torch.Generator) -> dict:
    """The decode kernel against its plain version on one layer (not 0) of
    full-size stacked caches, as the fused decode step calls it."""
    cfg = t5_lib.T5Config.t0_3b()
    layers, heads, head_dim = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv
    length = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    width = heads * head_dim
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    q = randn(BATCH, width)
    k = randn(layers, BATCH, length, width)
    v = randn(layers, BATCH, length, width)
    mask = torch.ones((BATCH, length), dtype=torch.int32, device=dev)
    for b in range(1, BATCH, 4):          # padded tails of several lengths
        mask[b, length - 40 - 3 * b:] = 0
    mask[BATCH - 1] = 0                   # one fully masked row
    args = (q, k, v, mask, DECODE_LAYER, heads)

    got = cross_attention_decode(*args)
    torch.cuda.synchronize()
    want = cross_attention_decode_plain(*args)
    err = (got.float() - want.float()).abs()
    max_abs_err = err.max().item()
    check(torch.isfinite(got.float()).all().item(),
          "decode kernel output not finite")
    check(bool((err <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all()),
          f"decode kernel outside atol/rtol 8e-3 of the plain version "
          f"(max abs err {max_abs_err})")
    kernel_ms = cuda_ms(lambda: cross_attention_decode(*args), iters=100)
    plain_ms = cuda_ms(lambda: cross_attention_decode_plain(*args), iters=5)
    # yardstick only: one PyTorch call computing the same function on
    # (B, H, 1, dh) and (B, H, L, dh) views of the same layer
    q4 = q.view(BATCH, heads, 1, head_dim)
    k4, v4 = (c[DECODE_LAYER].view(BATCH, length, heads, head_dim)
              .transpose(1, 2) for c in (k, v))
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).bfloat16()
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=bias, scale=1.0), iters=20)
    bytes_moved = (2 * BATCH * length * width * 2 + 2 * q.numel() * 2
                   + mask.numel() * 4)
    flops = 4 * BATCH * length * width
    result = dict(
        shape=dict(layers=layers, B=BATCH, L=length, H=heads, dh=head_dim,
                   layer=DECODE_LAYER),
        max_abs_err=max_abs_err, ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, library="scaled_dot_product_attention",
        **bound(bytes_moved, flops, BF16_FLOP_PER_S))
    emit("decode_attention", kernel_ms=kernel_ms, **{
        key: val for key, val in result.items() if key != "ms"})
    return result


def phase_t5_ffn(gen: torch.Generator) -> dict:
    """The bf16 FFN kernel against its plain version at the encoder's
    shapes (gated, T0-3B widths)."""
    cfg = t5_lib.T5Config.t0_3b()
    length = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    d_model, d_ff = cfg.d_model, cfg.d_ff
    rows = BATCH * length
    dev = gen.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    x = randn(BATCH, length, d_model, scale=2.0).bfloat16()
    lnw = (1 + 0.1 * randn(d_model)).bfloat16()
    wi_0, wi_1 = (randn(d_model, d_ff, scale=d_model ** -0.5).bfloat16()
                  for _ in range(2))
    wo = randn(d_ff, d_model, scale=d_ff ** -0.5).bfloat16()
    args = (x, lnw, wi_0, wi_1, wo, cfg.layer_norm_epsilon)
    got = fused_t5_ffn(*args)
    torch.cuda.synchronize()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain version must multiply in fp32")
    want = fused_t5_ffn_plain(*args)
    errs = compare_q8(got, want)
    del want
    kernel_ms = cuda_ms(lambda: fused_t5_ffn(*args), iters=10)
    plain_ms = cuda_ms(lambda: fused_t5_ffn_plain(*args), iters=3, warmup=1)
    # yardstick only: the unfused bf16 FFN the encoder runs without
    # fused_encoder_ffn (three cuBLAS matmuls, gelu, gate, residual)
    ffn_p = {"wi_0": wi_0, "wi_1": wi_1, "wo": wo}
    library_ms = cuda_ms(lambda: x + t5_lib._ffn_block(
        ffn_p, t5_lib.rms_norm(x, lnw, cfg.layer_norm_epsilon), cfg),
        iters=10)
    bytes_moved = 2 * rows * d_model * 2 + d_model * 2 + 3 * d_model * d_ff * 2
    flops = 3 * 2 * rows * d_model * d_ff
    result = dict(
        shape=dict(M=rows, D=d_model, F=d_ff, gated=True),
        ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        library="unfused bf16 FFN: rms_norm, 3 torch.matmul, gelu, gate",
        **errs, **bound(bytes_moved, flops, BF16_FLOP_PER_S))
    emit("t5_ffn", kernel_ms=kernel_ms, **{
        key: val for key, val in result.items() if key != "ms"})
    return result


def phase_generate_fused(model: VCT0Model, prefix, tokens, mask,
                         default: dict) -> dict:
    """Every fused kernel on: the default path's weights and prompts,
    generate twice, breakdown, profile, token agreement with the default
    path (recorded), and both configurations' calls in turns."""
    lm_cfg = dataclasses.replace(model.cfg.lm, fused_encoder_attention=True,
                                 fused_encoder_ffn=True,
                                 fused_decode_attention=True)
    fused = VCT0Model(dataclasses.replace(model.cfg, lm=lm_cfg),
                      dict(model.params))
    layers = lm_cfg.num_encoder_layers
    result = phase_generate(
        fused, prefix, tokens, mask,
        expected=lambda steps: launches(
            t5_attention_core=layers, fused_t5_ffn=layers,
            cross_attention_decode=lm_cfg.num_decoder_layers * steps),
        phase="generate_fused")
    breakdown = phase_breakdown(fused, prefix, tokens, mask,
                                phase="breakdown_fused")
    phase_profile(fused, prefix, tokens, mask, result["wall_s"],
                  phase="profile_fused")
    same = result["tokens"] == default["tokens"]
    turns = generate_in_turns({"bf16": model, "fused": fused}, prefix,
                              tokens, mask)
    decode = decode_in_turns(model, fused, prefix, tokens, mask)
    emit("fused_vs_bf16", token_agreement=same.float().mean().item(),
         first_token_agreement=same[:, 0].float().mean().item(),
         fused_decode_s=breakdown["decode_s"],
         generate_s_in_turns=turns,
         prompts_per_s_in_turns={k: [BATCH / t for t in v]
                                 for k, v in turns.items()},
         **decode)
    return result


def decode_in_turns(model: VCT0Model, fused: VCT0Model, prefix, tokens,
                    mask) -> dict:
    """The greedy decode alone, without and with cross_attention_decode,
    on the same encoder states: host-clock seconds in turns (bf16, fused,
    fused, bf16) and the device time of its kernels under the profiler."""
    lm = model.params["lm"]
    with torch.inference_mode():
        joint, joint_mask = model.encoder_calibration_batch(prefix, tokens,
                                                            mask)
        hidden = t5_lib.t5_encode(lm, model.cfg.lm, inputs_embeds=joint,
                                  attention_mask=joint_mask)
    cfgs = {"bf16": model.cfg.lm, "fused": dataclasses.replace(
        model.cfg.lm, fused_decode_attention=True)}

    def decode(name):
        with torch.inference_mode():
            greedy_decode_t5(lm, cfgs[name], hidden, joint_mask,
                             MAX_NEW_TOKENS)

    wall = {"bf16": [], "fused": []}
    for name in ("bf16", "fused", "fused", "bf16"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(name)
        torch.cuda.synchronize()
        wall[name].append(time.perf_counter() - t0)
    device = {}
    for name in cfgs:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            decode(name)
            torch.cuda.synchronize()
        device[name] = sum(
            e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    return dict(decode_s_in_turns=wall, decode_device_s=device)


def tree_bytes(tree) -> int:
    """Bytes of the distinct tensors of a params tree."""
    seen = {}

    def walk(node):
        if isinstance(node, dict):
            for child in node.values():
                walk(child)
        else:
            seen[node.data_ptr()] = node.numel() * node.element_size()

    walk(tree)
    return sum(seen.values())


def phase_generate_int8_all(model: VCT0Model, prefix, tokens, mask) -> dict:
    """Every int8 opt-in of base_env.jsonnet at once (the decode's int8
    cross-KV at the auto layout and the W8A16 step), with the attention
    kernel: calibrate and quantize, then generate twice."""
    lm_cfg = dataclasses.replace(
        model.cfg.lm, fused_encoder_attention=True, int8_encoder_ffn=True,
        int8_encoder_attn=True, int8_cross_kv=True, int8_decoder_step=True)
    int8 = VCT0Model(dataclasses.replace(model.cfg, lm=lm_cfg),
                     dict(model.params))
    int8.calibrate_and_quantize_int8(
        [dict(prefix=prefix, question_tokens=tokens, question_mask=mask)],
        alpha=0.5)
    dec = int8.params["lm"]["decoder"]
    check("step_q8" in dec and not dec["ffn"] and not dec["self_attn"],
          "the decode step's weights were not quantized with drop_bf16")
    layers = lm_cfg.num_encoder_layers
    result = phase_generate(
        int8, prefix, tokens, mask,
        expected=lambda steps: launches(
            t5_attention_core=layers, fused_t5_ln_qkv_q8=layers,
            fused_oproj_residual_q8=layers, fused_t5_ffn_q8=layers),
        phase="generate_int8_all")
    emit("int8_all_params", kv_layout=t5_lib._resolve_kv_layout(lm_cfg, BATCH),
         params_gb=tree_bytes(int8.params) / 1e9,
         bf16_params_gb=tree_bytes(model.params) / 1e9)
    phase_breakdown(int8, prefix, tokens, mask, phase="breakdown_int8_all")
    phase_profile(int8, prefix, tokens, mask, result["wall_s"],
                  phase="profile_int8_all")
    return result


def phase_kv_layouts(model: VCT0Model, gen: torch.Generator) -> None:
    """One decode step at full width and 2 decoder layers for each int8
    cross-KV layout, on the same encoder states."""
    lm = model.params["lm"]
    length = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    dev = gen.device
    hidden = torch.randn((BATCH, length, model.cfg.lm.d_model),
                         generator=gen, device=dev).bfloat16()
    mask = torch.ones((BATCH, length), dtype=torch.int32, device=dev)
    mask[1::4, length - 60:] = 0
    token = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
    logits, cache_bytes = {}, {}
    with torch.inference_mode():
        for layout in ("unmerged", "merged", "transposed"):
            cfg = dataclasses.replace(model.cfg.lm, num_decoder_layers=2,
                                      int8_cross_kv=True,
                                      int8_kv_layout=layout)
            cache = t5_lib.init_decode_cache(lm, cfg, hidden, MAX_NEW_TOKENS)
            cache_bytes[layout] = sum(
                t.numel() * t.element_size() for key, t in cache.items()
                if key.startswith("cross_"))
            logits[layout], _ = t5_lib.t5_decode_step(lm, cfg, token, cache,
                                                      mask)
            del cache
    check(bool(torch.isfinite(logits["unmerged"]).all()),
          "int8 cross-KV logits not finite")
    check(torch.equal(logits["unmerged"], logits["merged"]),
          "unmerged and merged int8 cross-KV logits differ")
    ref = logits["unmerged"]
    rel = ((logits["transposed"] - ref).norm() / ref.norm()).item()
    check(rel <= LAYOUT_REL_ERR,
          f"transposed int8 cross-KV logits differ from unmerged: rel {rel}")
    emit("kv_layouts", decoder_layers=2, batch=BATCH, length=length,
         transposed_rel_err=rel, limit=LAYOUT_REL_ERR,
         transposed_max_abs_diff=(logits["transposed"] - ref).abs().max()
         .item(),
         cross_cache_bytes_at_rest=cache_bytes)


def phase_vit_kernels(gen: torch.Generator) -> dict:
    """The three split3 kernels against their plain versions at ViT-L
    widths on VIT_CHECK_BATCH images and on CLIP_BATCH images, the main
    path's shape, then timed at CLIP_BATCH images."""
    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336()
    seq, width, heads = cfg.seq_len, cfg.width, cfg.num_heads
    d_ff = cfg.mlp_ratio * width
    dev = gen.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale) \
            .bfloat16()

    x = randn(CLIP_BATCH, seq, width)
    ln_s, ln_b = 1 + randn(width, scale=0.1), randn(width, scale=0.1)
    w = [randn(width, width, scale=width ** -0.5) for _ in range(4)]
    b = [randn(width, scale=0.1) for _ in range(4)]
    w_fc, b_fc = randn(width, d_ff, scale=width ** -0.5), randn(d_ff, scale=0.1)
    w_pr, b_pr = randn(d_ff, width, scale=d_ff ** -0.5), randn(width, scale=0.1)
    q, k, v = (randn(CLIP_BATCH, seq, width, scale=s) for s in (0.5, 2.0, 1.0))
    rows = CLIP_BATCH * seq
    act = rows * width * 2                 # one bf16 (M, D) activation
    f = torch.nn.functional

    # yardsticks only: PyTorch calls computing the same functions (layer
    # norm and cuBLAS matmuls over the concatenated QKV; scaled dot-product
    # attention, the out-projection and the residual; layer norm, two
    # matmuls and quickGELU); times, not value checks
    w_qkv, b_qkv = torch.cat(w[:3], dim=1), torch.cat(b[:3])

    def lib_qkv(n):
        h = f.layer_norm(x[:n], (width,), ln_s, ln_b, cfg.layer_norm_epsilon)
        return torch.addmm(b_qkv, h.view(-1, width), w_qkv)

    def lib_oproj(n):
        q4, k4, v4 = (t[:n].view(n, seq, heads, -1).transpose(1, 2)
                      for t in (q, k, v))
        o = f.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
        o = o.transpose(1, 2).reshape(-1, width)
        return x[:n].view(-1, width) + torch.addmm(b[3], o, w[3])

    def lib_mlp(n):
        h = f.layer_norm(x[:n], (width,), ln_s, ln_b, cfg.layer_norm_epsilon)
        z = torch.addmm(b_fc, h.view(-1, width), w_fc)
        return x[:n].view(-1, width) + torch.addmm(
            b_pr, z * torch.sigmoid(1.702 * z), w_pr)

    cases = {
        "fused_ln_qkv": dict(
            fn=fused_ln_qkv, plain=fused_ln_qkv_plain, library=lib_qkv,
            args=lambda n: (x[:n], ln_s, ln_b, w[0], b[0], w[1], b[1], w[2],
                            b[2], (width // heads) ** -0.5),
            bytes=4 * act + 3 * width * width * 2 + 5 * width * 2,
            ops=2 * rows * width * 3 * width),
        "attention_core_oproj": dict(
            fn=attention_core_oproj, plain=attention_core_oproj_plain,
            library=lib_oproj,
            args=lambda n: (x[:n], q[:n], k[:n], v[:n], w[3], b[3], heads),
            bytes=5 * act + width * width * 2 + width * 2,
            ops=4 * CLIP_BATCH * seq * seq * width + 2 * rows * width * width),
        "fused_mlp_block": dict(
            fn=fused_mlp_block, plain=fused_mlp_block_plain, library=lib_mlp,
            args=lambda n: (x[:n], ln_s, ln_b, w_fc, b_fc, w_pr, b_pr),
            bytes=2 * act + 2 * width * d_ff * 2 + (3 * width + d_ff) * 2,
            ops=4 * rows * width * d_ff),
    }
    results = {}
    for name, case in cases.items():
        fn, plain = case["fn"], case["plain"]
        small, full = case["args"](VIT_CHECK_BATCH), case["args"](CLIP_BATCH)
        # B=16 covers a ragged last row tile; B=256 is the main path's shape
        ragged = check_against_plain(name, fn, plain, small,
                                     VIT_CHECK_BATCH)
        main = check_against_plain(name, fn, plain, full, CLIP_BATCH)
        kernel_ms = cuda_ms(lambda: fn(*full), iters=10)
        plain_ms = cuda_ms(lambda: plain(*full), iters=2, warmup=1)
        library_ms = cuda_ms(lambda: case["library"](CLIP_BATCH), iters=10)
        torch.cuda.empty_cache()
        results[name] = dict(
            shape=dict(B=CLIP_BATCH, L=seq, D=width, H=heads, F=d_ff),
            **main, **{f"b{VIT_CHECK_BATCH}_{key}": val
                       for key, val in ragged.items()},
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            **bound(case["bytes"], case["ops"], BF16_FLOP_PER_S))
        emit("vit_kernels", kernel=name, kernel_ms=kernel_ms, **{
            key: val for key, val in results[name].items() if key != "ms"})
    return results


def phase_vit_q8_kernels(gen: torch.Generator) -> dict:
    """The int8 path's kernels against their plain versions at ViT-L widths
    on VIT_CHECK_BATCH and on CLIP_BATCH images, the main path's shape,
    with one layer's weights from the port's quantize_vision_blocks, then
    timed at CLIP_BATCH images."""
    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336()
    seq, width, heads = cfg.seq_len, cfg.width, cfg.num_heads
    d_ff = cfg.mlp_ratio * width
    dev = gen.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale) \
            .bfloat16()

    shapes = {"q": (width, width), "k": (width, width), "v": (width, width),
              "o": (width, width), "mlp_fc": (width, d_ff),
              "mlp_proj": (d_ff, width)}
    blocks = {name: randn(1, *shape, scale=shape[0] ** -0.5)
              for name, shape in shapes.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q8 = clip_lib.quantize_vision_blocks({"blocks": blocks})
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    on_cpu = clip_lib.quantize_vision_blocks(
        {"blocks": {name: w.cpu() for name, w in blocks.items()}})
    check(all(torch.equal(q8[key].cpu(), on_cpu[key]) for key in q8),
          "quantize_vision_blocks gives other codes or scales on the card "
          "than on the CPU")
    w_qkv, s_qkv = q8["qkv"][0], q8["qkv_scale"][0]
    w_fc, s_fc = q8["mlp_fc"][0], q8["mlp_fc_scale"][0]
    w_pr, s_pr = q8["mlp_proj"][0], q8["mlp_proj_scale"][0]
    x = randn(CLIP_BATCH, seq, width)
    ln_s, ln_b = 1 + randn(width, scale=0.1), randn(width, scale=0.1)
    b_qkv, b_fc, b_pr = (randn(n, scale=0.1) for n in (3 * width, d_ff, width))
    q, k, v = (randn(CLIP_BATCH, seq, width, scale=s) for s in (0.5, 2.0, 1.0))
    rows = CLIP_BATCH * seq
    act = rows * width * 2                 # one bf16 (M, D) activation

    def codes(k_dim):  # activation codes for the library yardstick
        return torch.randint(-127, 128, (rows, k_dim), generator=gen,
                             device=dev, dtype=torch.int8)

    def int_mm(gemms):
        # yardstick only: torch._int_mm of the same int8 products, GEMMs
        # alone, the weights column-major as cuBLASLt's int8 GEMM takes
        # them (the transposes made before the timing)
        pairs = [(codes(k_dim), w.t().contiguous().t()) for k_dim, w in gemms]
        return lambda: [torch._int_mm(a, w) for a, w in pairs]

    def sdpa():
        # yardstick only: on contiguous (B, H, L, dh) copies of q, k, v
        q4, k4, v4 = (t.view(CLIP_BATCH, seq, heads, -1).transpose(1, 2)
                      .contiguous() for t in (q, k, v))
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0)

    attention_bytes = 4 * act
    attention_flops = 4 * CLIP_BATCH * seq * seq * width
    cases = {
        "fused_qkv_q8": dict(
            fn=fused_qkv_q8, plain=fused_qkv_q8_plain, int8=True,
            args=lambda n: (x[:n], ln_s, ln_b, w_qkv, s_qkv, b_qkv,
                            (width // heads) ** -0.5),
            library=lambda: int_mm([(width, w_qkv)]),
            library_name="torch._int_mm, GEMMs only, column-major weights",
            bytes=4 * act + w_qkv.numel() + 3 * width * (4 + 2)
            + 2 * width * 2,
            ops=2 * rows * width * 3 * width, peak=INT8_OP_PER_S),
        "attention_core": dict(
            fn=attention_core, plain=attention_core_plain, int8=False,
            args=lambda n: (q[:n], k[:n], v[:n], heads), library=sdpa,
            library_name="scaled_dot_product_attention, contiguous "
                         "(B, H, L, dh) inputs",
            bytes=attention_bytes, ops=attention_flops, peak=BF16_FLOP_PER_S),
        "attention_core_fast_exp": dict(
            fn=lambda *a: attention_core(*a, fast_exp=True),
            plain=lambda *a: attention_core_plain(*a, fast_exp=True),
            int8=False, args=lambda n: (q[:n], k[:n], v[:n], heads),
            library=sdpa,
            library_name="scaled_dot_product_attention, contiguous "
                         "(B, H, L, dh) inputs",
            bytes=attention_bytes, ops=attention_flops, peak=BF16_FLOP_PER_S),
        "fused_mlp_block_q8": dict(
            fn=fused_mlp_block_q8, plain=fused_mlp_block_q8_plain, int8=True,
            args=lambda n: (x[:n], ln_s, ln_b, w_fc, s_fc, b_fc, w_pr, s_pr,
                            b_pr),
            library=lambda: int_mm([(width, w_fc), (d_ff, w_pr)]),
            library_name="torch._int_mm, GEMMs only, column-major weights",
            bytes=2 * act + w_fc.numel() + w_pr.numel()
            + (d_ff + width) * (4 + 2) + 2 * width * 2,
            ops=2 * 2 * rows * width * d_ff, peak=INT8_OP_PER_S),
    }

    results = {}
    for name, case in cases.items():
        # B=16 covers a ragged last row tile; B=256 is the main path's shape
        full = case["args"](CLIP_BATCH)
        ragged, main = (check_against_plain(
            name, case["fn"], case["plain"], case["args"](batch), batch,
            case["int8"]) for batch in (VIT_CHECK_BATCH, CLIP_BATCH))
        kernel_ms = cuda_ms(lambda: case["fn"](*full), iters=10)
        plain_ms = cuda_ms(lambda: case["plain"](*full), iters=2, warmup=1)
        library_ms = cuda_ms(case["library"](), iters=10)
        torch.cuda.empty_cache()
        results[name] = dict(
            shape=dict(B=CLIP_BATCH, L=seq, D=width, H=heads, F=d_ff),
            **main, **{f"b{VIT_CHECK_BATCH}_{key}": val
                       for key, val in ragged.items()},
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            library=case["library_name"],
            **bound(case["bytes"], case["ops"], case["peak"]))
        emit("vit_q8_kernels", kernel=name, kernel_ms=kernel_ms,
             quantize_layer_s=quantize_s, **{
                 key: val for key, val in results[name].items()
                 if key != "ms"})
    return results


def flat_leaves(tree, prefix: str = ""):
    """(path, tensor) for every leaf of a params tree."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from flat_leaves(val, f"{prefix}{key}/")
        else:
            yield prefix + key, val


def phase_t5_quantizers(gen: torch.Generator) -> None:
    """The T5 int8 weight quantizers at T0-3B widths and T5_QUANT_LAYERS
    layers: _quant_stacked_i8 on random stacked weights in 8 groups, and
    quantize_encoder_ffn / _attn and quantize_decoder_step on random
    params, each on the card and on a CPU copy of its input; every code and
    scale must be equal."""
    cfg = t5_lib.T5Config.t0_3b(num_encoder_layers=T5_QUANT_LAYERS,
                                num_decoder_layers=T5_QUANT_LAYERS)
    params = t5_lib.init_t5_params(gen, cfg, torch.bfloat16)

    def cpu_copy(tree):
        return {key: cpu_copy(val) if isinstance(val, dict) else val.cpu()
                for key, val in tree.items()}

    w = torch.randn((T5_QUANT_LAYERS, cfg.d_model, cfg.d_ff), generator=gen,
                    device=gen.device).mul_(cfg.d_model ** -0.5)
    quantized = {"_quant_stacked_i8": (
        dict(zip(("codes", "scales"), t5_lib._quant_stacked_i8(w, 8))),
        dict(zip(("codes", "scales"),
                 t5_lib._quant_stacked_i8(w.cpu(), 8))))}
    on_cpu = cpu_copy(params)
    for quantize in (t5_lib.quantize_encoder_ffn, t5_lib.quantize_encoder_attn,
                     t5_lib.quantize_decoder_step):
        quantized[quantize.__name__] = (quantize(params), quantize(on_cpu))
    leaves = {}
    for name, (card, host) in quantized.items():
        card, host = dict(flat_leaves(card)), dict(flat_leaves(host))
        check(card.keys() == host.keys(), f"{name}: other trees on the card")
        q8 = [key for key in card if "q8" in key or name.startswith("_")]
        differ = [key for key in q8 if not torch.equal(card[key].cpu(),
                                                       host[key])]
        check(not differ, f"{name} gives other codes or scales on the card "
                          f"than on the CPU: {differ}")
        leaves[name] = len(q8)
    emit("t5_quantizers", layers=T5_QUANT_LAYERS, d_model=cfg.d_model,
         d_ff=cfg.d_ff, bit_equal_leaves=leaves)


VIT_BLOCK_KEYS = ("ln1_scale", "ln1_bias", "q", "q_bias", "k", "k_bias", "v",
                  "v_bias", "o", "o_bias", "ln2_scale", "ln2_bias", "mlp_fc",
                  "mlp_fc_bias", "mlp_proj", "mlp_proj_bias")


def phase_vit_short_kernels(gen: torch.Generator) -> dict:
    """The ViT-B/32 whole-block kernels against their plain versions on
    VIT_CHECK_BATCH and on B32_BATCH images (one layer of the tower's
    seeded init weights, random LayerNorm parameters and biases; the int8
    weights from quantize_vision_blocks), then timed at B32_BATCH beside the
    plain version, the bound and a library yardstick."""
    cfg = clip_lib.CLIPVisionConfig.vit_b_32(num_layers=1)
    seq, width, heads = cfg.seq_len, cfg.width, cfg.num_heads
    head_dim, d_ff = width // heads, cfg.mlp_ratio * width
    dev = gen.device
    eps = cfg.layer_norm_epsilon
    layer = {name: leaf[0] for name, leaf in clip_lib.init_clip_vision_params(
        gen, cfg, torch.bfloat16)["blocks"].items()}
    for name, leaf in layer.items():
        if name.endswith(("bias", "scale")):
            base = 1.0 if name.endswith("scale") else 0.0
            layer[name] = (base + 0.1 * torch.randn(
                leaf.shape, generator=gen, device=dev)).bfloat16()
    q8 = {name: leaf[0] for name, leaf in clip_lib.quantize_vision_blocks(
        {"blocks": {n: layer[n][None] for n in (
            "q", "k", "v", "o", "mlp_fc", "mlp_proj")}}).items()}
    b_qkv = torch.cat([layer["q_bias"], layer["k_bias"], layer["v_bias"]])
    w_qkv = torch.cat([layer["q"], layer["k"], layer["v"]], dim=1)
    x = torch.randn((B32_BATCH, seq, width), generator=gen,
                    device=dev).bfloat16()
    block = [layer[n] for n in VIT_BLOCK_KEYS]
    q8_block = (layer["ln1_scale"], layer["ln1_bias"], q8["qkv"],
                q8["qkv_scale"], b_qkv, q8["o"], q8["o_scale"],
                layer["o_bias"], layer["ln2_scale"], layer["ln2_bias"],
                q8["mlp_fc"], q8["mlp_fc_scale"], layer["mlp_fc_bias"],
                q8["mlp_proj"], q8["mlp_proj_scale"], layer["mlp_proj_bias"])
    attn_args = [layer[n] for n in ("q", "q_bias", "k", "k_bias", "v",
                                    "v_bias", "o", "o_bias")]
    rows = B32_BATCH * seq
    act = rows * width * 2                 # one bf16 (M, D) activation
    f = torch.nn.functional

    # yardsticks only: PyTorch calls computing the same functions
    def lib_block():
        # the unfused bf16 block: layer norms, cuBLAS matmuls, SDPA,
        # quickGELU
        x2 = x.view(-1, width)
        h = f.layer_norm(x2, (width,), layer["ln1_scale"], layer["ln1_bias"],
                         eps)
        qkv = torch.addmm(b_qkv, h, w_qkv).view(B32_BATCH, seq, 3, heads,
                                                head_dim)
        o = f.scaled_dot_product_attention(*qkv.permute(2, 0, 3, 1, 4))
        r1 = x2 + torch.addmm(layer["o_bias"],
                              o.transpose(1, 2).reshape(-1, width),
                              layer["o"])
        z = torch.addmm(layer["mlp_fc_bias"], f.layer_norm(
            r1, (width,), layer["ln2_scale"], layer["ln2_bias"], eps),
            layer["mlp_fc"])
        return r1 + torch.addmm(layer["mlp_proj_bias"],
                                z * torch.sigmoid(1.702 * z),
                                layer["mlp_proj"])

    def lib_int_mm():
        # torch._int_mm of the four int8 products, GEMMs only, the weights
        # column-major as cuBLASLt's int8 GEMM takes them (made before the
        # timing)
        pairs = [(torch.randint(-127, 128, (rows, w.shape[0]), generator=gen,
                                device=dev, dtype=torch.int8),
                  w.t().contiguous().t())
                 for w in (q8["qkv"], q8["o"], q8["mlp_fc"], q8["mlp_proj"])]
        return lambda: [torch._int_mm(a, w) for a, w in pairs]

    def lib_f32():
        # fp32 matmuls (TF32 off) and fp32 SDPA, on fp32 copies made before
        # the timing
        x32, wqkv32, wo32 = (t.float() for t in (x.view(-1, width), w_qkv,
                                                 layer["o"]))
        bqkv32, bo32 = b_qkv.float(), layer["o_bias"].float()

        def run():
            qkv = torch.addmm(bqkv32, x32, wqkv32).view(
                B32_BATCH, seq, 3, heads, head_dim)
            o = f.scaled_dot_product_attention(*qkv.permute(2, 0, 3, 1, 4))
            return torch.addmm(bo32, o.transpose(1, 2).reshape(-1, width),
                               wo32)
        return run

    vecs = (4 * width + 4 * width + d_ff + width) * 2   # LNs and biases
    weights = 4 * width * width + 2 * width * d_ff
    attention_flops = 4 * B32_BATCH * seq * seq * width
    block_bytes = 2 * act + weights * 2 + vecs
    block_parts = [(2 * rows * weights + attention_flops, BF16_FLOP_PER_S)]
    cases = {
        f"fused_vit_block{suffix}": dict(
            fn=lambda *a, kw=kw: fused_vit_block(*a, group=4, **kw),
            plain=lambda *a, kw=kw: fused_vit_block_plain(*a, **kw),
            args=lambda n: (x[:n], *block, heads), int8=False,
            library=lambda: lib_block,
            library_name="the unfused bf16 block: layer_norm, addmm, "
                         "scaled_dot_product_attention, quickGELU",
            bytes=block_bytes, parts=block_parts)
        for suffix, kw in (("", {}), ("_deferred_div", {"deferred_div": True}),
                           ("_fast_exp", {"fast_exp": True}))}
    cases["fused_vit_block_q8"] = dict(
        fn=lambda *a: fused_vit_block_q8(*a, group=4),
        plain=fused_vit_block_q8_plain,
        args=lambda n: (x[:n], *q8_block, heads), int8=True,
        library=lib_int_mm,
        library_name="torch._int_mm, GEMMs only, column-major weights",
        bytes=2 * act + weights + (4 * width + d_ff + width) * 4 + vecs,
        parts=[(2 * rows * weights, INT8_OP_PER_S),
               (attention_flops, BF16_FLOP_PER_S)])
    cases["fused_attention_block"] = dict(
        fn=lambda *a: fused_attention_block(*a, group=4, block_diag=True),
        plain=lambda *a: fused_attention_block_plain(*a, block_diag=True),
        args=lambda n: (x[:n], *attn_args, heads), int8=False,
        library=lib_f32,
        library_name="fp32 addmm (TF32 off) and fp32 "
                     "scaled_dot_product_attention",
        bytes=2 * act + 4 * width * width * 2 + 4 * width * 2,
        # this route: bf16 q, k, v; fp32 attention on the CUDA cores; the
        # out-projection as three bf16 products over the split fp32 input
        parts=[(2 * rows * 3 * width * width, BF16_FLOP_PER_S),
               (attention_flops, FP32_FLOP_PER_S),
               (3 * 2 * rows * width * width, BF16_FLOP_PER_S)])
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain versions must multiply in fp32")
    results = {}
    for name, case in cases.items():
        full = case["args"](B32_BATCH)
        ragged, main = (check_against_plain(
            name, case["fn"], case["plain"], case["args"](batch), batch,
            case["int8"]) for batch in (VIT_CHECK_BATCH, B32_BATCH))
        kernel_ms = cuda_ms(lambda: case["fn"](*full), iters=10)
        plain_ms = cuda_ms(lambda: case["plain"](*full), iters=2, warmup=1)
        library_ms = cuda_ms(case["library"](), iters=10)
        torch.cuda.empty_cache()
        results[name] = dict(
            shape=dict(B=B32_BATCH, L=seq, D=width, H=heads, F=d_ff, G=4),
            **main, **{f"b{VIT_CHECK_BATCH}_{key}": val
                       for key, val in ragged.items()},
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            library=case["library_name"],
            **bound_mixed(case["bytes"], case["parts"]))
        emit("vit_short_kernels", kernel=name, kernel_ms=kernel_ms, **{
            key: val for key, val in results[name].items() if key != "ms"})
    return results


def encode_with_counts(encoder, images, expected: dict, what: str) -> tuple:
    """One encode_batch call with every kernel count set to 0 just before
    it and read just after; the counts must equal ``expected``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in PATH_KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    out = encoder.encode_batch(images)
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in PATH_KERNELS}
    check(counts == expected,
          f"{what}: kernels launched {counts}, expected {expected}")
    return out, dict(wall_s=wall, launches=counts,
                     peak_bytes=torch.cuda.max_memory_allocated())


def row_cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def phase_clip_variants(gen: torch.Generator, cfg, params, images,
                        phase: str, reference: tuple, variants: dict) -> None:
    """One encode at SPLIT_FE_LAYERS layers of each of ``variants`` (name
    -> (config, expected launches)) against ``reference`` (name, config,
    expected launches) at that depth, on the same weights and images."""
    dev = gen.device
    shallow = dict(params)
    shallow["blocks"] = {key: leaf[:SPLIT_FE_LAYERS]
                         for key, leaf in params["blocks"].items()}
    ref_name, ref_cfg, ref_launches = reference
    paths = {ref_name: (ref_cfg, ref_launches), **variants}
    outs, runs = {}, {}
    for name, (path_cfg, expected) in paths.items():
        encoder = ClipImageEncoder(path_cfg, shallow, batch_size=CLIP_BATCH,
                                   device=dev)
        outs[name], runs[name] = encode_with_counts(
            encoder, images, expected, f"{phase} {name}")
    cosines = {}
    for name in variants:
        cosine = row_cosine(outs[name], outs[ref_name])
        check(bool(np.isfinite(outs[name]).all()),
              f"{name} embeddings not finite")
        check(bool((cosine >= CLIP_COSINE_FLOOR).all()),
              f"{name} embeddings' cosine to the {ref_name} path's "
              f"{cosine.min()} < {CLIP_COSINE_FLOOR}")
        cosines[name] = dict(min=float(cosine.min()),
                             mean=float(cosine.mean()))
    emit(phase, layers=SPLIT_FE_LAYERS, batch=CLIP_BATCH, reference=ref_name,
         cosine=cosines, floor=CLIP_COSINE_FLOOR,
         launches={name: run["launches"] for name, run in runs.items()},
         wall_s={name: run["wall_s"] for name, run in runs.items()})


def encode_paths(phase: str, encoders: dict, per_call: dict, images,
                 num_layers: int, floor: float = CLIP_COSINE_FLOOR) -> dict:
    """Each encoder (name -> ClipImageEncoder; "default" first) called twice
    with the kernel counts set to 0 before each call and read after it
    (``per_call[name]``'s kernels num_layers times, the others never), then
    its busy share; the other paths' per-row cosines to the default path's;
    and the calls in turns."""
    batch = images.shape[0]
    results, outs = {}, {}
    for name, encoder in encoders.items():
        want = launches(**{fn.__name__: num_layers
                           for fn in per_call[name]})
        runs = []
        for _ in range(2):
            out, run = encode_with_counts(encoder, images, want,
                                          f"{phase} {name}")
            runs.append(run)
        check(out.shape == (batch, encoder.cfg.projection_dim),
              f"{phase} {name}: embeddings {out.shape}")
        check(bool(np.isfinite(out).all()),
              f"{phase} {name}: embeddings not finite")
        outs[name] = out
        wall = runs[-1]["wall_s"]
        results[name] = dict(
            wall_s=wall, first_wall_s=runs[0]["wall_s"],
            images_per_s=batch / wall,
            peak_mem_gb=runs[-1]["peak_bytes"] / 1e9,
            launches_per_call=[r["launches"] for r in runs],
            **device_busy(lambda: encoder.encode_batch(images), wall, top=6))
        emit(phase, path=name, batch=batch, seq=encoder.cfg.seq_len,
             **results[name])
    cosines = {}
    for name in encoders:
        if name == "default":
            continue
        cosine = row_cosine(outs[name], outs["default"])
        check(bool((cosine >= floor).all()),
              f"{phase} {name} embeddings' cosine to the default path's "
              f"{cosine.min()} < {floor}")
        cosines[name] = dict(min=float(cosine.min()),
                             mean=float(cosine.mean()))
    turns = {name: [] for name in encoders}
    order = list(encoders)
    for name in order + order[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encoders[name].encode_batch(images)
        turns[name].append(time.perf_counter() - t0)
    emit(phase + "_vs_default", cosine=cosines, floor=floor,
         encode_s_in_turns=turns,
         images_per_s_in_turns={k: [batch / t for t in v]
                                for k, v in turns.items()})
    return results


def phase_clip_encode(gen: torch.Generator) -> dict:
    """ClipImageEncoder at ViT-L/14@336, the default path, fused_block and
    int8 on the same weights and images (encode_paths); one split_fe encode
    and one whole and one whole_dd encode at 2 layers; and one
    ClipTextEncoder call."""
    dev = gen.device
    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336()
    params = clip_lib.init_clip_vision_params(gen, cfg, torch.bfloat16)
    encoders = {
        "default": ClipImageEncoder(cfg, params, batch_size=CLIP_BATCH,
                                    device=dev),
        "fused": ClipImageEncoder(dataclasses.replace(cfg, fused_block=True),
                                  params, batch_size=CLIP_BATCH, device=dev),
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encoders["int8"] = ClipImageEncoder(cfg, params, batch_size=CLIP_BATCH,
                                        int8=True, device=dev)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    check("blocks_q8" not in params and encoders["int8"].cfg.int8,
          "ClipImageEncoder(int8=True) changed the caller's params or did "
          "not set cfg.int8")
    images = torch.randn((CLIP_BATCH, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device=dev).bfloat16()
    results = encode_paths(
        "clip_encode", encoders,
        {"default": (), "fused": VIT_KERNELS, "int8": VIT_Q8_KERNELS},
        images, cfg.num_layers)
    results["int8"]["quantize_s"] = quantize_s
    emit("clip_int8_quantize", seconds=quantize_s)
    del encoders
    torch.cuda.empty_cache()
    depth = dataclasses.replace(cfg, num_layers=SPLIT_FE_LAYERS)
    n = SPLIT_FE_LAYERS
    phase_clip_variants(
        gen, cfg, params, images, "clip_split_fe",
        ("default", depth, launches()),
        {"split_fe": (dataclasses.replace(depth, fused_block=True,
                                          fused_block_long="split_fe"),
                      launches(attention_core=n, fused_mlp_block=n))})
    split3 = dataclasses.replace(depth, fused_block=True)
    phase_clip_variants(
        gen, cfg, params, images, "clip_whole",
        ("split3", split3, launches(**{fn.__name__: n for fn in VIT_KERNELS})),
        {name: (dataclasses.replace(split3, fused_block_long=name),
                launches(fused_vit_block=n))
         for name in ("whole", "whole_dd")})
    del params, images
    torch.cuda.empty_cache()

    text_cfg = clip_lib.CLIPTextConfig()
    text = ClipTextEncoder(
        text_cfg, clip_lib.init_clip_text_params(gen, text_cfg,
                                                 torch.bfloat16),
        batch_size=TEXT_BATCH, device=dev)
    ids = torch.randint(1, text_cfg.vocab_size - 1,
                        (TEXT_BATCH, text_cfg.context_length), generator=gen,
                        device=dev, dtype=torch.int32)
    eot = torch.randint(2, text_cfg.context_length, (TEXT_BATCH,),
                        generator=gen, device=dev)
    ids[torch.arange(TEXT_BATCH, device=dev), eot] = text_cfg.vocab_size - 1
    text.encode_ids(ids)                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text_out = text.encode_ids(ids)
    text_s = time.perf_counter() - t0
    check(text_out.shape == (TEXT_BATCH, text_cfg.projection_dim)
          and bool(np.isfinite(text_out).all()),
          "text embeddings not finite or of the wrong shape")
    emit("clip_text", batch=TEXT_BATCH, length=text_cfg.context_length,
         wall_s=text_s, texts_per_s=TEXT_BATCH / text_s)
    return results


def phase_clip_encode_b32(gen: torch.Generator) -> dict:
    """ClipImageEncoder at ViT-B/32 (12 layers) on B32_BATCH images: the
    default path, fused (the JAX bench's configuration), int8 and
    fused_attention on the same weights and images (encode_paths)."""
    dev = gen.device
    cfg = clip_lib.CLIPVisionConfig.vit_b_32()
    params = clip_lib.init_clip_vision_params(gen, cfg, torch.bfloat16)
    bench = dataclasses.replace(cfg, fast_attention=True,
                                fused_attention=True, fused_block=True)
    encoders = {
        "default": ClipImageEncoder(cfg, params, batch_size=B32_BATCH,
                                    device=dev),
        "fused": ClipImageEncoder(bench, params, batch_size=B32_BATCH,
                                  device=dev),
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encoders["int8"] = ClipImageEncoder(cfg, params, batch_size=B32_BATCH,
                                        int8=True, device=dev)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    check("blocks_q8" not in params and encoders["int8"].cfg.int8,
          "ClipImageEncoder(int8=True) changed the caller's params or did "
          "not set cfg.int8")
    encoders["fused_attention"] = ClipImageEncoder(
        dataclasses.replace(cfg, fused_attention=True), params,
        batch_size=B32_BATCH, device=dev)
    images = torch.randn((B32_BATCH, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device=dev).bfloat16()
    results = encode_paths(
        "clip_encode_b32", encoders,
        {"default": (), "fused": (fused_vit_block,),
         "int8": (fused_vit_block_q8,),
         "fused_attention": (fused_attention_block,)},
        images, cfg.num_layers)
    results["int8"]["quantize_s"] = quantize_s
    emit("clip_b32_int8_quantize", seconds=quantize_s)
    return results


def gpt2_layer(gen: torch.Generator, cfg) -> list:
    """One GPT-2 layer at ``cfg``'s widths, bf16: init-scale weights, random
    LayerNorm parameters and biases, in the kernel's argument order."""
    dev = gen.device
    layer = {name: leaf[0] for name, leaf in gpt2_lib.init_gpt2_params(
        gen, dataclasses.replace(cfg, num_layers=1))["blocks"].items()}
    for name, leaf in layer.items():
        if name.endswith(("bias", "scale")):
            base = 1.0 if name.endswith("scale") else 0.0
            layer[name] = (base + 0.1 * torch.randn(
                leaf.shape, generator=gen, device=dev)).bfloat16()
    return [layer[n] for n in GPT2_BLOCK_KEYS]


def right_padded_mask(batch: int, length: int, dev, shortest: int) -> torch.Tensor:
    """(B, L) int32: row b valid on its first L - (b % 8) (L - shortest) / 7
    positions (every eighth row full, the shortest ``shortest``)."""
    mask = torch.zeros((batch, length), dtype=torch.int32, device=dev)
    for b in range(batch):
        mask[b, :length - (b % 8) * (length - shortest) // 7] = 1
    return mask


def gpt2_block_ops(mask: torch.Tensor, d_model: int, d_ff: int) -> float:
    """The block's operations on these inputs: the four projections over
    every row, and QK^T and PV over each query's visible valid keys."""
    rows = mask.numel()
    projections = 2 * rows * (4 * d_model * d_model + 2 * d_model * d_ff)
    pairs = int(mask.long().cumsum(dim=1).sum())
    return projections + 4 * d_model * pairs


def phase_gpt2_block(gen: torch.Generator) -> dict:
    """fused_gpt2_block against its plain version at GPT-2 small widths
    (D = 768, 12 heads, F = 3072): B=32, L=64 (G = 4) and B=8, L=128 with
    right-padded rows; B=6, L=64 (G = 2) with a left-padded row that sees no
    valid key; then timed at B=32, L=64 and L=128 beside the plain version,
    the bound and the unfused bf16 block."""
    cfg = gpt2_lib.GPT2Config.gpt2_small()
    d_model, heads, d_ff = cfg.d_model, cfg.num_heads, 4 * cfg.d_model
    head_dim, eps = d_model // heads, cfg.layer_norm_epsilon
    dev = gen.device
    params = gpt2_layer(gen, cfg)
    (ln1_s, ln1_b, w_qkv, b_qkv, w_out, b_out, ln2_s, ln2_b, w_fc, b_fc,
     w_proj, b_proj) = params
    f = torch.nn.functional

    def inputs(batch, length, left_pad=0):
        x = torch.randn((batch, length, d_model), generator=gen,
                        device=dev).bfloat16()
        mask = right_padded_mask(batch, length, dev, length // 2)
        mask[1, :left_pad] = 0
        return x, mask

    checks = {}
    for batch, length, left_pad in ((32, 64, 0), (8, 128, 0), (6, 64, 7)):
        x, mask = inputs(batch, length, left_pad)
        checks[f"B{batch}_L{length}" + ("_left_padded" if left_pad else "")] \
            = check_against_plain(
                "fused_gpt2_block", lambda *a: fused_gpt2_block(*a, heads),
                lambda *a: fused_gpt2_block_plain(*a, heads),
                (x, mask, *params), batch)
    timed = {}
    for batch, length in ((32, 64), (32, 128)):
        x, mask = inputs(batch, length)
        args = (x, mask, *params, heads)
        causal = torch.ones((length, length), dtype=torch.bool,
                            device=dev).tril()
        sdpa_mask = causal[None, None] & (mask[:, None, None, :] > 0)

        def lib_block():
            # yardstick only: the unfused bf16 block (layer_norm, cuBLAS
            # addmm, scaled_dot_product_attention with the causal and key
            # mask, tanh gelu)
            x2 = x.view(-1, d_model)
            h = f.layer_norm(x2, (d_model,), ln1_s, ln1_b, eps)
            qkv = torch.addmm(b_qkv, h, w_qkv).view(batch, length, 3, heads,
                                                    head_dim)
            o = f.scaled_dot_product_attention(*qkv.permute(2, 0, 3, 1, 4),
                                               attn_mask=sdpa_mask)
            r1 = x2 + torch.addmm(b_out, o.transpose(1, 2).reshape(
                -1, d_model), w_out)
            z = torch.addmm(b_fc, f.layer_norm(r1, (d_model,), ln2_s, ln2_b,
                                               eps), w_fc)
            return r1 + torch.addmm(b_proj, f.gelu(z, approximate="tanh"),
                                    w_proj)

        rows = batch * length
        bytes_moved = (2 * rows * d_model * 2 + mask.numel() * 4
                       + sum(p.numel() * 2 for p in params))
        timed[f"L{length}"] = dict(
            shape=dict(B=batch, L=length, D=d_model, H=heads, F=d_ff,
                       G=gpt2_block_group(batch)),
            ms=cuda_ms(lambda: fused_gpt2_block(*args), iters=20),
            plain_ms=cuda_ms(lambda: fused_gpt2_block_plain(*args), iters=3,
                             warmup=1),
            library_ms=cuda_ms(lib_block, iters=20),
            **bound(bytes_moved, gpt2_block_ops(mask, d_model, d_ff),
                    BF16_FLOP_PER_S))
        emit("gpt2_block_timed", **timed[f"L{length}"])
    main = checks["B32_L64"]
    result = dict(**timed["L64"], max_abs_err=max(
        c["max_abs_err"] for c in checks.values()), checks=checks,
        at_L128=timed["L128"],
        library="the unfused bf16 block: layer_norm, addmm, "
                "scaled_dot_product_attention (causal and key mask), "
                "gelu(approximate='tanh')",
        differing_share=main["differing"] / main["elements"])
    emit("gpt2_block", **{k: v for k, v in result.items()
                          if k not in ("at_L128",)})
    return result


def check_within_one_ulp(name: str, got: torch.Tensor,
                         want: torch.Tensor) -> dict:
    """Every element within one bf16 ulp of the plain version's: the ulp of
    the larger of the two values (neighbours across a power of two), and
    at least that of rms(want) / 256 (outputs near zero, where fp32 sums in
    another order move by more than their own ulps)."""
    g, w = got.float(), want.float()
    floor = w.square().mean().sqrt() / 256
    top = torch.maximum(torch.maximum(g.abs(), w.abs()), floor)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    err = (g - w).abs()
    check(bool(torch.isfinite(g).all()), f"{name}: output not finite")
    check(bool((err <= ulp).all()),
          f"{name}: {int((err > ulp).sum())} elements beyond one bf16 ulp of "
          f"the plain version (max abs err {err.max().item()})")
    return dict(max_abs_err=err.max().item(), differing=int((err > 0).sum()),
                elements=err.numel())


def phase_flash_attention(gen: torch.Generator) -> dict:
    """flash_attention against its plain version on 16 images at ViT-L/14@336
    widths (L = 577, 16 heads of 64, bf16, no bias) and on a small shape
    under a (B, 1, 1, Lk) key-mask bias (one row masked entirely) and a
    per-(batch, head) bias; then timed at CLIP_BATCH beside the plain
    version, the bound and scaled_dot_product_attention on fp32 copies."""
    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336()
    seq, heads = cfg.seq_len, cfg.num_heads
    head_dim = cfg.width // heads
    dev = gen.device

    def qkv(batch, length, n_heads):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        return ((randn(batch, length, n_heads, head_dim) * head_dim ** -0.5)
                .bfloat16(), randn(batch, length, n_heads, head_dim).bfloat16(),
                randn(batch, length, n_heads, head_dim).bfloat16())

    checks = {}
    q, k, v = qkv(VIT_CHECK_BATCH, seq, heads)
    checks[f"B{VIT_CHECK_BATCH}"] = check_within_one_ulp(
        "flash_attention", flash_attention(q, k, v),
        flash_attention_plain(q, k, v))
    q, k, v = qkv(3, 200, 4)
    key_mask = torch.zeros((3, 1, 1, 200), device=dev)
    key_mask[1, ..., 120:] = -1e9
    key_mask[2] = -1e9
    per_head = torch.randn((3, 4, 200, 200), generator=gen, device=dev)
    for name, bias in (("key_mask", key_mask), ("per_batch_head", per_head)):
        checks[name] = check_within_one_ulp(
            f"flash_attention {name}", flash_attention(q, k, v, bias),
            flash_attention_plain(q, k, v, bias))
    del q, k, v
    torch.cuda.empty_cache()

    q, k, v = qkv(CLIP_BATCH, seq, heads)
    kernel_ms = cuda_ms(lambda: flash_attention(q, k, v), iters=10)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), iters=2,
                       warmup=1)
    torch.cuda.empty_cache()
    # yardstick only: SDPA on the fp32-upcast inputs (B, H, L, dh)
    q32, k32, v32 = (t.float().transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q32, k32, v32, scale=1.0), iters=10)
    del q32, k32, v32
    flops = 2 * CLIP_BATCH * heads * seq * seq * head_dim
    main = checks[f"B{VIT_CHECK_BATCH}"]
    result = dict(
        shape=dict(B=CLIP_BATCH, L=seq, H=heads, dh=head_dim),
        ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        library="scaled_dot_product_attention, fp32 inputs, scale=1.0",
        max_abs_err=max(c["max_abs_err"] for c in checks.values()),
        checks=checks, differing_share=main["differing"] / main["elements"],
        # this route: q k^T on the tensor cores, PV as three exact bf16
        # products
        **bound_mixed(4 * q.numel() * 2, [(flops, BF16_FLOP_PER_S),
                                          (3 * flops, BF16_FLOP_PER_S)]))
    del q, k, v
    torch.cuda.empty_cache()
    emit("flash_attention", kernel_ms=kernel_ms,
         **{key: val for key, val in result.items() if key != "ms"})
    return result


def clipcap_batch(gen: torch.Generator, tokens: int, answer: int = 5):
    """CLIPCAP_BATCH right-padded token rows of ``tokens`` (the shortest
    half as long), their mask, and labels on each row's last ``answer``
    valid tokens (-100 elsewhere)."""
    dev = gen.device
    ids = torch.randint(0, 50256, (CLIPCAP_BATCH, tokens), generator=gen,
                        device=dev, dtype=torch.int32)
    mask = right_padded_mask(CLIPCAP_BATCH, tokens, dev, tokens // 2)
    labels = torch.full_like(ids, -100)
    for b, valid in enumerate(mask.sum(dim=1).tolist()):
        labels[b, valid - answer:valid] = ids[b, valid - answer:valid]
    return ids, mask, labels


def timed_call(fn, expected: dict, what: str) -> tuple:
    """fn() with every kernel count set to 0 just before and read just
    after (they must equal ``expected``), on the host clock to a
    synchronize, with the peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in PATH_KERNELS:
        kernel.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {kernel.__name__: kernel.launches for kernel in PATH_KERNELS}
    check(counts == expected,
          f"{what}: kernels launched {counts}, expected {expected}")
    return out, dict(wall_s=wall, launches=counts,
                     peak_bytes=torch.cuda.max_memory_allocated())


def phase_clipcap(gen: torch.Generator) -> dict:
    """ClipCap at GPT-2 small width and depth with the mlp mapper (512 ->
    10 x 768), random weights from SEED, prefixes from ViT-B/32
    ClipImageEncoder embeddings of CLIPCAP_BATCH random images: generate
    twice (no kernel), the loss at 64 positions with fused_block (12
    fused_gpt2_block launches) and without it (none), and at 138 positions
    with fused_block (none, as in JAX)."""
    dev = gen.device
    vit = clip_lib.CLIPVisionConfig.vit_b_32()
    encoder = ClipImageEncoder(
        vit, clip_lib.init_clip_vision_params(gen, vit, torch.bfloat16),
        batch_size=CLIPCAP_BATCH, device=dev)
    images = torch.randn((CLIPCAP_BATCH, vit.image_size, vit.image_size, 3),
                         generator=gen, device=dev).bfloat16()
    prefix, encode = timed_call(
        lambda: torch.from_numpy(encoder.encode_batch(images)).to(dev),
        launches(), "clipcap image encode")
    check(tuple(prefix.shape) == (CLIPCAP_BATCH, vit.projection_dim)
          and bool(torch.isfinite(prefix).all()), "prefix embeddings")
    del encoder, images
    torch.cuda.empty_cache()

    lm_cfg = gpt2_lib.GPT2Config.gpt2_small(fused_block=True)
    cfg = clipcap_lib.ClipCapConfig.from_model_args(CLIPCAP_MODEL_ARGS,
                                                    lm_cfg=lm_cfg)
    t0 = time.perf_counter()
    model = clipcap_lib.build_clipcap_prefix(
        cfg, clipcap_lib.init_clipcap_params(cfg, seed=SEED, device=dev))
    torch.cuda.synchronize()
    emit("clipcap_init", seconds=time.perf_counter() - t0,
         params_gb=torch.cuda.memory_allocated() / 1e9)

    # generate: CLIPCAP_BATCH prompts of up to CLIPCAP_PROMPT tokens
    prompt, prompt_mask, _ = clipcap_batch(gen, CLIPCAP_PROMPT)
    runs = []
    for _ in range(2):
        (tokens, logprobs), run = timed_call(
            lambda: model.generate(prefix, prompt, prompt_mask,
                                   max_new_tokens=MAX_NEW_TOKENS),
            launches(), "clipcap generate")
        runs.append(dict(run, tokens=tokens, logprobs=logprobs))
    check(torch.equal(runs[0]["tokens"], runs[1]["tokens"]),
          "clipcap: the two generate calls gave different tokens")
    check(tuple(tokens.shape) == (CLIPCAP_BATCH, MAX_NEW_TOKENS)
          and bool(((tokens >= 0) & (tokens < lm_cfg.vocab_size)).all()),
          "clipcap tokens")
    check(bool(torch.isfinite(logprobs).all() & (logprobs <= 0).all()),
          "clipcap log-probs")
    wall = runs[1]["wall_s"]
    generate = dict(
        batch=CLIPCAP_BATCH, prompt_tokens=CLIPCAP_PROMPT,
        positions=cfg.prefix_length + CLIPCAP_PROMPT,
        new_tokens=MAX_NEW_TOKENS, wall_s=wall,
        first_wall_s=runs[0]["wall_s"], prompts_per_s=CLIPCAP_BATCH / wall,
        peak_mem_gb=runs[1]["peak_bytes"] / 1e9,
        launches_per_call=[r["launches"] for r in runs],
        first_tokens=tokens[0, :5].tolist(),
        **device_busy(lambda: model.generate(prefix, prompt, prompt_mask,
                                             max_new_tokens=MAX_NEW_TOKENS),
                      wall, top=6))
    emit("clipcap_generate", image_encode_s=encode["wall_s"], **generate)
    generate["breakdown"] = clipcap_generate_breakdown(model, prefix, prompt,
                                                       prompt_mask)
    emit("clipcap_generate_breakdown", **generate["breakdown"])

    # the teacher-forced loss, a forward pass
    n_layers = lm_cfg.num_layers
    ids, mask, labels = clipcap_batch(gen, CLIPCAP_LOSS_TOKENS)
    unfused = clipcap_lib.build_clipcap_prefix(
        dataclasses.replace(cfg, lm=dataclasses.replace(
            lm_cfg, fused_block=False)), model.params)
    losses, loss_runs = {}, {}
    with torch.inference_mode():
        for name, path, want in (("fused", model, n_layers),
                                 ("unfused", unfused, 0)):
            calls = []
            for _ in range(2):
                value, run = timed_call(
                    lambda: path.forward_loss(prefix, ids, mask, labels),
                    launches(fused_gpt2_block=want), f"clipcap loss {name}")
                calls.append(run)
            losses[name] = float(value)
            loss_runs[name] = dict(
                wall_s=calls[1]["wall_s"], first_wall_s=calls[0]["wall_s"],
                peak_mem_gb=calls[1]["peak_bytes"] / 1e9,
                launches_per_call=[c["launches"] for c in calls],
                **device_busy(lambda: path.forward_loss(prefix, ids, mask,
                                                        labels),
                              calls[1]["wall_s"], top=6))
        rel = abs(losses["fused"] - losses["unfused"]) / abs(losses["unfused"])
        check(all(np.isfinite(v) and v > 0 for v in losses.values()),
              f"clipcap losses {losses}")
        check(rel <= CLIPCAP_LOSS_REL,
              f"clipcap fused loss {losses['fused']} against unfused "
              f"{losses['unfused']}: rel {rel} > {CLIPCAP_LOSS_REL}")
        long_ids, long_mask, long_labels = clipcap_batch(
            gen, CLIPCAP_BUCKET_TOKENS)
        long_loss, long_run = timed_call(
            lambda: model.forward_loss(prefix, long_ids, long_mask,
                                       long_labels),
            launches(), "clipcap loss at the 128-token bucket")
        check(bool(torch.isfinite(long_loss)), "clipcap loss at 138 positions")
    loss = dict(batch=CLIPCAP_BATCH, tokens=CLIPCAP_LOSS_TOKENS,
                positions=cfg.prefix_length + CLIPCAP_LOSS_TOKENS,
                losses=losses, rel_diff=rel, limit=CLIPCAP_LOSS_REL,
                **{name: run for name, run in loss_runs.items()},
                bucket=dict(tokens=CLIPCAP_BUCKET_TOKENS,
                            positions=cfg.prefix_length
                            + CLIPCAP_BUCKET_TOKENS,
                            loss=float(long_loss), wall_s=long_run["wall_s"],
                            launches=long_run["launches"]))
    emit("clipcap_loss", **loss)
    loss["breakdown"] = clipcap_loss_breakdown(model, prefix, ids, mask)
    emit("clipcap_loss_breakdown", **loss["breakdown"])
    loss["launches_per_call"] = loss_runs["fused"]["launches_per_call"]
    return dict(generate=generate, loss=loss)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def clipcap_generate_breakdown(model, prefix, prompt, prompt_mask) -> dict:
    """The generate call's parts, each ending in a synchronize: mapper and
    embedding, prefill, the greedy decode loop (prefill included)."""
    cfg, lm = model.cfg, model.params["lm"]
    with torch.inference_mode():
        (embeds, mask), embed_s = timed(lambda: clipcap_lib.embed_with_prefix(
            cfg, lm, model.params["mapper"], prefix, prompt, prompt_mask))
        cache = gpt2_lib.init_gpt2_cache(cfg.lm, CLIPCAP_BATCH,
                                         embeds.shape[1] + MAX_NEW_TOKENS,
                                         device=embeds.device)
        _, prefill_s = timed(lambda: gpt2_lib.gpt2_prefill(
            lm, cfg.lm, embeds, mask, cache))
        _, decode_s = timed(lambda: greedy_decode_gpt2(
            lm, cfg.lm, embeds, mask, max_new_tokens=MAX_NEW_TOKENS))
    return dict(mapper_embed_s=embed_s, prefill_s=prefill_s,
                greedy_decode_s=decode_s,
                decode_steps_s=decode_s - prefill_s,
                decode_step_ms=(decode_s - prefill_s)
                / (MAX_NEW_TOKENS - 1) * 1e3)


def clipcap_loss_breakdown(model, prefix, ids, mask) -> dict:
    """The fused loss call's parts, each ending in a synchronize: mapper and
    embedding, the 12 fused blocks, and the final LayerNorm, LM head and
    log-softmax."""
    cfg, lm = model.cfg, model.params["lm"]
    with torch.inference_mode():
        (embeds, full_mask), embed_s = timed(
            lambda: clipcap_lib.embed_with_prefix(
                cfg, lm, model.params["mapper"], prefix, ids, mask))

        def blocks():
            x = embeds
            for i in range(cfg.lm.num_layers):
                x = fused_gpt2_block(
                    x, full_mask, *(lm["blocks"][n][i]
                                    for n in GPT2_BLOCK_KEYS),
                    num_heads=cfg.lm.num_heads)
            return x

        x, blocks_s = timed(blocks)

        def head():
            logits = gpt2_lib.lm_logits(lm, cfg.lm, x)
            return torch.log_softmax(logits[:, :-1].float(), dim=-1)

        _, head_s = timed(head)
    return dict(mapper_embed_s=embed_s, fused_blocks_s=blocks_s,
                head_log_softmax_s=head_s)


def phase_clip_encode_pallas(gen: torch.Generator) -> dict:
    """ClipImageEncoder(use_pallas=True) at ViT-L/14@336 on CLIP_BATCH
    images beside the default path (encode_paths): 24 flash_attention
    launches a call, per-row cosine to the default path at least
    PALLAS_COSINE_FLOOR."""
    dev = gen.device
    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336()
    params = clip_lib.init_clip_vision_params(gen, cfg, torch.bfloat16)
    encoders = {
        "default": ClipImageEncoder(cfg, params, batch_size=CLIP_BATCH,
                                    device=dev),
        "use_pallas": ClipImageEncoder(cfg, params, batch_size=CLIP_BATCH,
                                       use_pallas=True, device=dev),
    }
    images = torch.randn((CLIP_BATCH, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device=dev).bfloat16()
    return encode_paths("clip_encode_pallas", encoders,
                        {"default": (), "use_pallas": (flash_attention,)},
                        images, cfg.num_layers, floor=PALLAS_COSINE_FLOOR)


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
    int8_kernels = phase_int8_kernels(gen)
    torch.cuda.empty_cache()
    decode_attention = phase_decode_attention(gen)
    torch.cuda.empty_cache()
    t5_ffn = phase_t5_ffn(gen)
    torch.cuda.empty_cache()

    lm_cfg = t5_lib.T5Config.t0_3b(fused_encoder_attention=True)
    cfg = VCT0Config(
        lm=lm_cfg,
        mapper=MapperConfig(mapping_type="mlp", prefix_size=PREFIX_SIZE,
                            d_model=lm_cfg.d_model,
                            prefix_length=PREFIX_LENGTH,
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
    layers = cfg.lm.num_encoder_layers
    generate = phase_generate(
        model, prefix, tokens, mask,
        expected=lambda steps: launches(t5_attention_core=layers))
    breakdown = phase_breakdown(model, prefix, tokens, mask)
    phase_profile(model, prefix, tokens, mask, generate["wall_s"])
    generate_int8 = phase_generate_int8(model, prefix, tokens, mask,
                                        breakdown["encode_s"])
    torch.cuda.empty_cache()
    generate_fused = phase_generate_fused(model, prefix, tokens, mask,
                                          generate)
    torch.cuda.empty_cache()
    phase_generate_int8_all(model, prefix, tokens, mask)
    torch.cuda.empty_cache()
    phase_kv_layouts(model, gen)
    del model
    torch.cuda.empty_cache()
    vit_kernels = phase_vit_kernels(gen)
    torch.cuda.empty_cache()
    vit_q8_kernels = phase_vit_q8_kernels(gen)
    torch.cuda.empty_cache()
    clip_encode = phase_clip_encode(gen)
    torch.cuda.empty_cache()
    phase_t5_quantizers(gen)
    torch.cuda.empty_cache()
    vit_short = phase_vit_short_kernels(gen)
    torch.cuda.empty_cache()
    clip_b32 = phase_clip_encode_b32(gen)
    torch.cuda.empty_cache()
    gpt2_block = phase_gpt2_block(gen)
    torch.cuda.empty_cache()
    flash = phase_flash_attention(gen)
    torch.cuda.empty_cache()
    clipcap = phase_clipcap(gen)
    torch.cuda.empty_cache()
    clip_pallas = phase_clip_encode_pallas(gen)

    measured = {
        "t5_attention_core": (attention, generate),
        **{name: (res, generate_int8) for name, res in int8_kernels.items()},
        "cross_attention_decode": (decode_attention, generate_fused),
        "fused_t5_ffn": (t5_ffn, generate_fused),
        **{name: (res, clip_encode["fused"])
           for name, res in vit_kernels.items()},
        **{name: (vit_q8_kernels[name], clip_encode["int8"])
           for name in ("fused_qkv_q8", "attention_core",
                        "fused_mlp_block_q8")},
        "fused_vit_block": (vit_short["fused_vit_block"], clip_b32["fused"]),
        "fused_vit_block_q8": (vit_short["fused_vit_block_q8"],
                               clip_b32["int8"]),
        "fused_attention_block": (vit_short["fused_attention_block"],
                                  clip_b32["fused_attention"]),
        "fused_gpt2_block": (gpt2_block, clipcap["loss"]),
        "flash_attention": (flash, clip_pallas["use_pallas"]),
    }
    lines = []
    for name, (res, run) in measured.items():
        source, replaces = KERNELS[name]
        lines.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": run["launches_per_call"][-1][name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
        })
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
