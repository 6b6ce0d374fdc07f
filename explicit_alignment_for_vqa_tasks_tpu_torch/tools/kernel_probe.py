"""A short first check of the bf16 kernels on the card, for the first chip
call after a kernel edit: build them with the compiler's register /
shared-memory / spill report, run each once against its plain version, and
time it.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.kernel_probe
    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.kernel_probe \
        --int8-digests [--int8-times]
    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.kernel_probe \
        --bf16-times
    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.kernel_probe \
        --epilogue-cost
    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.kernel_probe \
        --ffn-variants DIR [DIR ...]
    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.kernel_probe \
        --flash-reference
    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.kernel_probe \
        --attention-variants DIR [DIR ...]
    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.kernel_probe \
        --flash-variants DIR [DIR ...]

Shapes: ``fused_t5_ffn`` at M = 32 x 557 rows, D = 2048, F = 5120 (gated),
with a SHA-256 of its bf16 output (the inputs come from a seeded generator,
so two builds of the kernel can be compared bit for bit); the same digests
of the int8 T5 encoder kernels (``fused_t5_ln_qkv_q8``,
``fused_oproj_residual_q8``, ``fused_t5_ffn_q8`` gated and not) at M = 32 x
557 rows, D = inner = 2048, F = 5120, 8 contraction groups, and of the ViT
ones (``fused_qkv_q8`` and ``fused_mlp_block_q8`` at ViT-L/14@336 widths on
16 images, ``fused_vit_block_q8`` at ViT-B/32's on 64) with
``--int8-digests``; ``--int8-times`` (with or without the digests) times
them at the main shapes (ViT-L on 256 images, ViT-B/32 on 1024) with each
CUDA kernel's device ms. Both need only what the port had since its int8
whole block, so this file copied into an older tree digests and times that
tree's build; ``--bf16-times`` times ``t5_attention_core`` at the main
path's shape (B = 32, L = 557, 32 heads of 64, padded tails and a fully
masked row), ``fused_ln_qkv`` at ViT-L/14@336 widths on 256 images,
``attention_core`` (both orders), ``attention_core_oproj`` and
``flash_attention`` at ViT-L/14@336's attention on 256 images,
``fused_vit_block`` and ``fused_attention_block`` (block_diag, and without
it in both ``compute_dtype``s where the tree has them) at ViT-B/32's on
1024, ``fused_gpt2_block`` at GPT-2
small's on 32 sequences of 64 and of 128 positions, ``fused_t5_ffn`` (gated
and not) at the main path's shape and ``fused_mlp_block`` at ViT-L/14@336
widths on 256 images, each with a SHA-256 of its outputs and its CUDA
kernels' device ms (the norm stage among them), in the same way;
``--ffn-variants DIR...`` times the last three by CUDA kernel as built
from each given copy of ``csrc/`` (in parallel, with their ptxas reports),
in turns; ``--epilogue-cost`` does so for this tree's ``csrc/`` and a copy
built with ``BF16_GEMM_TMA_BARE_EPILOGUE`` (the GEMMs with no epilogue
arithmetic or reads);
``cross_attention_decode`` on layer 7 of 24 stacked (32, 557, 2048) bf16
caches; the CLIP ViT ``split3`` kernels (``fused_ln_qkv``,
``attention_core_oproj``, ``fused_mlp_block``) and the int8 path's
(``fused_qkv_q8``, ``attention_core`` with and without ``fast_exp``,
``fused_mlp_block_q8``, weights from ``quantize_vision_blocks``) at
ViT-L/14@336 widths on 16 images (L = 577, D = 1024, 16 heads, F = 4096),
``attention_core_oproj`` with its attention stage timed alone, and both
attention kernels with the bound of their two-pass route (operations,
exponentials and bytes), with ``fused_vit_block`` there too in its long
``whole`` and ``whole_dd`` orders; the short-sequence whole blocks
(``fused_vit_block`` in its three softmax orders, ``fused_vit_block_q8``,
``fused_attention_block``) at ViT-B/32 widths on 16 images (L = 50, D =
768, 12 heads, F = 3072); ``fused_gpt2_block`` at GPT-2 small widths (D =
768, 12 heads, F = 3072) on 32 sequences of 64 positions (right-padded
rows) and on 6 (a left-padded row with no visible key, G = 2);
``flash_attention`` at ViT-L/14@336's attention on 16 images (L = 577, 16
heads of 64, no bias) and on a small shape under a key-mask and a
per-(batch, head) bias; with ``--flash-reference`` alone,
``flash_attention`` and its plain version on 2 images at ViT-L/14@336's
attention, each against an fp64 reference; with ``--attention-variants``
alone, ``attention_core`` (both orders) built from each given copy of
``csrc/`` (versions of ``vit_attention_wgmma.cuh``, built in parallel, each
with its ptxas serialization warnings, spills and registers), checked
against the plain version and timed at ViT-L/14@336 with B = 256, in turns
(the list, then reversed); with ``--flash-variants`` alone, the same for
``flash_attention`` (checked within one bf16 ulp on 16 images and at head
size 128, with the share of outputs that differ from plain).
Prints one line per report and per kernel; ``chip_smoke.py`` makes the full
measurement.
"""

from __future__ import annotations

import hashlib
import inspect
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

import torch

from .. import kernels
from ..models import clip
from ..models import gpt2
from ..models.t5 import _quant_stacked_i8
from ..ops import attention as attn
from ..ops import decode_attention as da
from ..ops import fused_attention_block as fab


def cuda_ms(fn, iters: int) -> float:
    for _ in range(2):
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


def _shape(run: dict) -> tuple:
    return tuple(sorted((kind, len(us)) for kind, us in run.items()))


def _traced_calls(fn, marker, calls: int) -> list:
    """One torch.profiler session over ``calls`` calls of fn, each after a
    fill of ``marker``: per call, kind -> its kernels' microseconds in
    launch order."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            marker.zero_()
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    runs = []
    for event in events:
        if "FillFunctor" in event.name:
            runs.append({})
            continue
        if not runs:
            continue
        kind = next((k for k in ("row_quant", "layer_norm", "rms_norm",
                                 "masked_rows", "attention", "gemm")
                     if k in event.name), "other")
        runs[-1].setdefault(kind, []).append(event.time_range.elapsed_us())
    return runs


def kernel_split(fn, calls: int = 6, rounds: int = 8) -> dict:
    """The device ms per call of each CUDA kernel that fn launches, under
    torch.profiler over ``calls`` calls after a warm one: its row_quant,
    layer_norm, rms_norm, masked_rows, attention and GEMM kernels numbered
    in launch order
    (``row_quant_0``, ``gemm_0``, ...), every other kernel (PyTorch's
    copies) summed as ``other``. A fill kernel before each call marks where
    the call begins; a session's first fill often goes unrecorded, and
    then its first call with it. The profiler drops other records now and
    then too; in a process that has run many traces most calls of a
    session may lose one. So sessions are traced until one comes back with
    at least two calls, all of one shape, and that session counts; when
    none of ``rounds`` does, the calls of the largest shape seen in at
    least two calls count (a dropped record only shrinks a call's
    shape)."""
    marker = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    runs = []
    for attempt in range(1, rounds + 1):
        session = _traced_calls(fn, marker, calls)
        shapes = {_shape(run) for run in session}
        if len(session) >= 2 and len(shapes) == 1:
            whole, complete = shapes.pop(), session
            if attempt > 1:
                print(f"kernel_split: session {attempt} of {calls} calls "
                      f"traced whole", file=sys.stderr, flush=True)
            break
        runs += session
    else:
        shapes = [_shape(run) for run in runs]
        seen = {shape for shape in shapes if shapes.count(shape) >= 2}
        if not seen:
            raise RuntimeError(
                f"kernel_split: no call shape seen twice in {rounds} sessions "
                f"of {calls} calls: "
                f"{sorted(((shapes.count(s), s) for s in set(shapes)), reverse=True)}")
        whole = max(seen, key=lambda shape: (sum(n for _, n in shape),
                                             shapes.count(shape)))
        complete = [run for run, shape in zip(runs, shapes) if shape == whole]
        print(f"kernel_split: no session of {calls} calls traced whole in "
              f"{rounds}; {len(complete)} of {len(runs)} calls of the largest "
              f"shape seen twice count", file=sys.stderr, flush=True)
    split = {"other": sum(sum(run.get("other", [])) for run in complete)
             / len(complete) / 1e3}
    for kind, count in whole:
        if kind == "other":
            continue
        for i in range(count):
            split[f"{kind}_{i}"] = sum(run[kind][i] for run in complete) \
                / len(complete) / 1e3
    return split


def sha256_of(outs) -> str:
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for out in outs:
        digest.update(out.view(torch.int16).cpu().numpy().tobytes())
    return digest.hexdigest()


def int8_cases(vit_l_batch: int, b32_batch: int) -> dict:
    """name -> (kernel, its arguments) of the int8 kernels at the main
    path's T5 shapes (M = 32 x 557, D = inner = 2048, F = 5120, 8 groups),
    ViT-L/14@336 widths on ``vit_l_batch`` images and ViT-B/32's on
    ``b32_batch``, all from seeded generators."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def quant(k, n):
        q, s = _quant_stacked_i8(randn(1, k, n, scale=k ** -0.5), 8)
        return q[0], s[0]

    rows, d_model, d_ff = 32 * 557, 2048, 5120
    x = randn(1, rows, d_model, scale=2.0).bfloat16()
    attn = randn(1, rows, d_model).bfloat16()
    lnw = (1 + 0.1 * randn(d_model)).bfloat16()
    qkv = [t for _ in range(3) for t in quant(d_model, d_model)]
    o = quant(d_model, d_model)
    ffn = [t for k, n in ((d_model, d_ff), (d_model, d_ff), (d_ff, d_model))
           for t in quant(k, n)]
    cfg = clip.CLIPVisionConfig.vit_l_14_336(num_layers=1)
    vit_l = vit_block_q8_case(cfg, vit_l_batch)
    return {
        "fused_t5_ln_qkv_q8": (fab.fused_t5_ln_qkv_q8, (x, lnw, *qkv)),
        "fused_oproj_residual_q8": (fab.fused_oproj_residual_q8,
                                    (x, attn, *o)),
        "fused_t5_ffn_q8": (fab.fused_t5_ffn_q8, (x, lnw, *ffn)),
        "fused_t5_ffn_q8 non-gated": (
            fab.fused_t5_ffn_q8, (x, lnw, *ffn[:2], None, None, *ffn[4:])),
        "fused_qkv_q8": (fab.fused_qkv_q8,
                         (*vit_l[:6], (cfg.width // cfg.num_heads) ** -0.5)),
        "fused_mlp_block_q8": (fab.fused_mlp_block_q8,
                               (vit_l[0], *vit_l[9:17])),
        "fused_vit_block_q8": (fab.fused_vit_block_q8, vit_block_q8_case(
            clip.CLIPVisionConfig.vit_b_32(num_layers=1), b32_batch)),
    }


def int8_encoder_digests() -> None:
    """A SHA-256 of each int8 kernel's output on int8_cases' inputs (ViT-L
    on 16 images, ViT-B/32 on 64)."""
    print("int8_encoder library", kernels.library_path("int8_encoder").name)
    print("vit_block_q8 library", kernels.library_path("vit_block_q8").name)
    for name, (fn, args) in int8_cases(16, 64).items():
        out = fn(*args)
        print(f"{name} output sha256",
              sha256_of(out if isinstance(out, tuple) else [out]), flush=True)


def int8_times(cases: dict, label: str = "") -> None:
    """Each of the cases' kernels (int8_cases', bf16_cases'): CUDA-event ms
    and each CUDA kernel's device ms, one line each after ``label``."""
    for name, (fn, args) in cases.items():
        print(f"{label}{name}: {cuda_ms(lambda: fn(*args), 10)} ms; by CUDA "
              f"kernel {kernel_split(lambda: fn(*args))}", flush=True)


def bf16_cases() -> dict:
    """name -> (kernel, its arguments) of t5_attention_core at the main
    path's shape (B = 32, L = 557, 32 heads of 64; padded tails and a fully
    masked row), fused_ln_qkv at ViT-L/14@336 widths on 256 images,
    attention_core (both orders), attention_core_oproj and flash_attention
    at its attention, fused_vit_block and fused_attention_block (each form
    the tree has) at ViT-B/32's on 1024 (one layer of the tower's init
    weights, random LayerNorm parameters and biases), fused_gpt2_block at
    GPT-2 small's on 32 sequences of 64 and of 128 positions (right-padded
    rows; one layer the same way), and ffn_cases', all from seeded
    generators; only what the port had since its whole blocks."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    batch, seq, heads, dh = 32, 557, 32, 64
    q, k = (randn(batch, seq, heads * dh, scale=0.5).bfloat16()
            for _ in range(2))
    v = (torch.rand((batch, seq, heads * dh), generator=gen, device="cuda")
         * 2 - 1).bfloat16()
    bias = randn(heads, seq, seq, scale=0.5)
    mask = torch.ones((batch, seq), dtype=torch.int32, device="cuda")
    for b in range(1, batch, 4):
        mask[b, seq - 40 - 3 * b:] = 0
    mask[batch - 1] = 0
    cases = {"t5_attention_core": (fab.t5_attention_core,
                                   (q, k, v, bias, mask, heads))}
    width = 1024
    x = randn(256, 577, width).bfloat16()
    ln = [(1 + randn(width, scale=0.1)).bfloat16(),
          randn(width, scale=0.1).bfloat16()]
    wb = [t for _ in range(3) for t in (
        randn(width, width, scale=width ** -0.5).bfloat16(),
        randn(width, scale=0.1).bfloat16())]
    cases["fused_ln_qkv"] = (fab.fused_ln_qkv, (x, *ln, *wb, 64 ** -0.5))
    # the wgmma attention in each of its ViT orders and flash_attention's,
    # and attention_core_oproj, at ViT-L/14@336's attention on 256 images
    q, k, v = (randn(256, 577, width, scale=s).bfloat16()
               for s in (0.5, 2.0, 1.0))
    for fe in (False, True):
        cases[f"attention_core fast_exp={fe}"] = (
            lambda *a, fe=fe: fab.attention_core(*a, fast_exp=fe),
            (q, k, v, 16))
    cases["attention_core_oproj"] = (fab.attention_core_oproj,
                                     (x, q, k, v, wb[0], wb[1], 16))
    cases["flash_attention"] = (attn.flash_attention, tuple(
        t.view(256, 577, 16, 64) for t in (q, k, v)))
    cfg = clip.CLIPVisionConfig.vit_b_32(num_layers=1)
    layer = {name: leaf[0] for name, leaf in clip.init_clip_vision_params(
        gen, cfg)["blocks"].items()}
    for name, leaf in layer.items():
        if name.endswith(("bias", "scale")):
            base = 1.0 if name.endswith("scale") else 0.0
            layer[name] = (base + randn(*leaf.shape, scale=0.1)).bfloat16()
    block = [layer[n] for n in (
        "ln1_scale", "ln1_bias", "q", "q_bias", "k", "k_bias", "v", "v_bias",
        "o", "o_bias", "ln2_scale", "ln2_bias", "mlp_fc", "mlp_fc_bias",
        "mlp_proj", "mlp_proj_bias")]
    x_b32 = randn(1024, cfg.seq_len, cfg.width).bfloat16()
    cases["fused_vit_block"] = (fab.fused_vit_block, (
        x_b32, *block, cfg.num_heads))
    # fused_attention_block in each form this tree has (block_diag; without
    # it in fp32 and bf16 compute_dtype, where the wrapper takes one)
    attn_args = (x_b32, *block[2:10], cfg.num_heads)
    forms = {"block_diag": {"block_diag": True}}
    if "compute_dtype" in inspect.signature(
            fab.fused_attention_block).parameters:
        forms.update({f"compute_dtype={d}": {"compute_dtype": d}
                      for d in (torch.float32, torch.bfloat16)})
    for form, kw in forms.items():
        cases[f"fused_attention_block {form}"] = (
            lambda *a, kw=kw: fab.fused_attention_block(*a, group=4, **kw),
            attn_args)
    gpt2_cfg = gpt2.GPT2Config.gpt2_small(num_layers=1)
    layer = {name: leaf[0] for name, leaf in gpt2.init_gpt2_params(
        gen, gpt2_cfg)["blocks"].items()}
    for name, leaf in layer.items():
        if name.endswith(("bias", "scale")):
            base = 1.0 if name.endswith("scale") else 0.0
            layer[name] = (base + randn(*leaf.shape, scale=0.1)).bfloat16()
    for seq in (64, 128):
        mask = torch.ones((32, seq), dtype=torch.int32, device="cuda")
        for b in range(32):
            mask[b, seq - b % 9:] = 0
        cases[f"fused_gpt2_block L={seq}"] = (fab.fused_gpt2_block, (
            randn(32, seq, gpt2_cfg.d_model).bfloat16(), mask,
            *(layer[n] for n in fab.GPT2_BLOCK_KEYS), gpt2_cfg.num_heads))
    cases.update(ffn_cases())
    return cases


def ffn_cases() -> dict:
    """name -> (kernel, its arguments) of fused_t5_ffn at the main path's
    shape (M = 32 x 557, D = 2048, F = 5120; gated and not) and
    fused_mlp_block at ViT-L/14@336 widths on 256 images (D = 1024, F =
    4096), from a seeded generator."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).bfloat16()

    d_model, d_ff = 2048, 5120
    x = randn(32, 557, d_model, scale=2.0)
    lnw = 1 + randn(d_model, scale=0.1)
    wi_0, wi_1 = (randn(d_model, d_ff, scale=d_model ** -0.5)
                  for _ in range(2))
    wo = randn(d_ff, d_model, scale=d_ff ** -0.5)
    width, d_ff = 1024, 4096
    mlp = (randn(256, 577, width), 1 + randn(width, scale=0.1),
           randn(width, scale=0.1), randn(width, d_ff, scale=width ** -0.5),
           randn(d_ff, scale=0.1), randn(d_ff, width, scale=d_ff ** -0.5),
           randn(width, scale=0.1))
    return {
        "fused_t5_ffn": (fab.fused_t5_ffn, (x, lnw, wi_0, wi_1, wo)),
        "fused_t5_ffn non-gated": (fab.fused_t5_ffn,
                                   (x, lnw, wi_0, None, wo)),
        "fused_mlp_block": (fab.fused_mlp_block, mlp),
    }


def bf16_digests(cases: dict) -> None:
    """A SHA-256 of each case's outputs (all of q, k and v for
    fused_ln_qkv)."""
    for name, (fn, args) in cases.items():
        out = fn(*args)
        print(f"{name} output sha256",
              sha256_of(out if isinstance(out, tuple) else [out]),
              flush=True)


def epilogue_cost() -> None:
    """ffn_variants of this tree's csrc/ and of a copy whose
    bf16_gemm_tma.cuh is built with BF16_GEMM_TMA_BARE_EPILOGUE (every
    epilogue only rounds acc to bf16, no residual or bias read): each
    GEMM's epilogue costs at most its difference."""
    bare = kernels.BUILD_DIR.parent / "variants" / "bare_epilogue"
    shutil.rmtree(bare, ignore_errors=True)
    shutil.copytree(kernels.CSRC_DIR, bare)
    header = bare / "bf16_gemm_tma.cuh"
    header.write_text("#define BF16_GEMM_TMA_BARE_EPILOGUE 1\n"
                      + header.read_text())
    ffn_variants([kernels.CSRC_DIR, bare])


def ffn_variants(dirs: List[Path]) -> None:
    """fused_t5_ffn (gated and not) and fused_mlp_block built from each
    csrc copy in ``dirs`` (in parallel, with their ptxas reports), a
    SHA-256 of each one's outputs, then timed by CUDA kernel at ffn_cases'
    shapes in turns (the list, then reversed). The wrappers are this
    tree's: the copies must keep its launchers' signatures."""
    built = build_variants(dirs, ["t5_ffn", "vit_block"])
    cases = ffn_cases()
    for d in built:
        kernels.CSRC_DIR = d
        kernels._loaded.clear()
        print(d.name, flush=True)
        bf16_digests(cases)
    for d in built + built[::-1]:
        kernels.CSRC_DIR = d
        kernels._loaded.clear()
        int8_times(cases, f"{d.name}: ")


def vit_block_q8_case(cfg, batch: int, seed: int = 0) -> tuple:
    """fused_vit_block_q8's arguments at ``cfg``'s widths on ``batch``
    images from a seeded generator: one layer of the tower's init weights
    quantized by quantize_vision_blocks, random LayerNorm parameters and
    biases, bf16 images' tokens."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    layer = {name: leaf[0] for name, leaf in clip.init_clip_vision_params(
        gen, cfg)["blocks"].items()}
    for name, leaf in layer.items():
        if name.endswith(("bias", "scale")):
            base = 1.0 if name.endswith("scale") else 0.0
            layer[name] = (base + 0.1 * torch.randn(
                leaf.shape, generator=gen, device="cuda")).bfloat16()
    q8 = {n: t[0] for n, t in clip.quantize_vision_blocks(
        {"blocks": {n: layer[n][None] for n in (
            "q", "k", "v", "o", "mlp_fc", "mlp_proj")}}).items()}
    x = torch.randn((batch, cfg.seq_len, cfg.width), generator=gen,
                    device="cuda").bfloat16()
    b_qkv = torch.cat([layer[n + "_bias"] for n in "qkv"])
    return (x, layer["ln1_scale"], layer["ln1_bias"], q8["qkv"],
            q8["qkv_scale"], b_qkv, q8["o"], q8["o_scale"], layer["o_bias"],
            layer["ln2_scale"], layer["ln2_bias"], q8["mlp_fc"],
            q8["mlp_fc_scale"], layer["mlp_fc_bias"], q8["mlp_proj"],
            q8["mlp_proj_scale"], layer["mlp_proj_bias"], cfg.num_heads)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: no CUDA device")
    if {"--int8-digests", "--int8-times"} & set(sys.argv[1:]):
        if "--int8-digests" in sys.argv[1:]:
            int8_encoder_digests()
        if "--int8-times" in sys.argv[1:]:
            print(torch.cuda.get_device_name(0), flush=True)
            int8_times(int8_cases(256, 1024))
        return
    if "--bf16-times" in sys.argv[1:]:
        print(torch.cuda.get_device_name(0), flush=True)
        cases = bf16_cases()
        bf16_digests(cases)
        int8_times(cases)
        return
    if "--epilogue-cost" in sys.argv[1:]:
        print(torch.cuda.get_device_name(0), flush=True)
        epilogue_cost()
        return
    if sys.argv[1:2] == ["--ffn-variants"]:
        print(torch.cuda.get_device_name(0), flush=True)
        ffn_variants([Path(d).resolve() for d in sys.argv[2:]])
        return
    if "--flash-reference" in sys.argv[1:]:
        flash_reference()
        return
    if sys.argv[1:2] == ["--attention-variants"]:
        attention_variants([Path(d).resolve() for d in sys.argv[2:]])
        return
    if sys.argv[1:2] == ["--flash-variants"]:
        print(torch.cuda.get_device_name(0), flush=True)
        flash_variants([Path(d).resolve() for d in sys.argv[2:]])
        return
    if sys.argv[1:2] == ["--q8-variants"]:
        q8_variants([Path(d).resolve() for d in sys.argv[2:]])
        return
    logs = kernels.build(["cross_attention_decode", "t5_ffn", "vit_block",
                          "vit_block_q8", "gpt2_block", "flash_attention"],
                         ptxas_verbose=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(name, line.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).bfloat16()

    rows, d_model, d_ff = 32 * 557, 2048, 5120
    x = randn(32, 557, d_model, scale=2.0)
    lnw = torch.ones(d_model, device="cuda").bfloat16()
    wi_0, wi_1 = (randn(d_model, d_ff, scale=d_model ** -0.5)
                  for _ in range(2))
    wo = randn(d_ff, d_model, scale=d_ff ** -0.5)
    args = (x, lnw, wi_0, wi_1, wo)
    got = fab.fused_t5_ffn(*args)
    print("fused_t5_ffn output sha256", sha256_of([got]))
    got = got.float()
    want = fab.fused_t5_ffn_plain(*args).float()
    print(f"fused_t5_ffn M={rows}: rel err "
          f"{((got - want).norm() / want.norm()).item()}, max abs err "
          f"{(got - want).abs().max().item()}, "
          f"{cuda_ms(lambda: fab.fused_t5_ffn(*args), 20)} ms")

    k, v = (randn(24, 32, 557, d_model) for _ in range(2))
    q = randn(32, d_model)
    mask = torch.ones(32, 557, dtype=torch.int32, device="cuda")
    mask[3, 500:] = 0
    args = (q, k, v, mask, 7, 32)
    got = da.cross_attention_decode(*args).float()
    want = da.cross_attention_decode_plain(*args).float()
    print(f"cross_attention_decode: max abs err "
          f"{(got - want).abs().max().item()}, "
          f"{cuda_ms(lambda: da.cross_attention_decode(*args), 100)} ms")
    vit_probe(randn)
    vit_q8_probe(randn)
    whole_block_probe(randn, clip.CLIPVisionConfig.vit_l_14_336(num_layers=1),
                      {"whole": {}, "whole_dd": {"deferred_div": True}})
    whole_block_probe(randn, clip.CLIPVisionConfig.vit_b_32(num_layers=1),
                      {"normalised": {},
                       "deferred_div": {"deferred_div": True},
                       "whole_fe": {"fast_exp": True}}, short=True)
    clipcap_probe(randn)


def attention_route_bound(name: str, batch: int, seq: int, width: int,
                          heads: int, bytes_moved: float,
                          extra_ops: float = 0.0) -> None:
    """Prints the bound of the two-pass wgmma attention's route on an H100
    SXM: q . k^T twice and p . v (plus ``extra_ops``) at 989 TFLOP/s, the
    B H L^2 exponentials at 16 a clock on each of 132 SMs at 1.98 GHz, the
    bytes at 3.35 TB/s."""
    parts = dict(
        operations=(6 * batch * seq * seq * width + extra_ops) / 989e12,
        exponentials=batch * heads * seq * seq / (132 * 16 * 1.98e9),
        bytes=bytes_moved / 3.35e12)
    print(f"{name} B={batch}: route bound "
          + ", ".join(f"{k} {v * 1e3} ms" for k, v in parts.items()))


def vit_probe(randn) -> None:
    batch, seq, width, heads, d_ff = 16, 577, 1024, 16, 4096
    x = randn(batch, seq, width)
    ln_s, ln_b = 1 + randn(width, scale=0.1), randn(width, scale=0.1)
    w = [randn(width, width, scale=width ** -0.5) for _ in range(4)]
    b = [randn(width, scale=0.1) for _ in range(4)]
    w_fc, b_fc = randn(width, d_ff, scale=width ** -0.5), randn(d_ff, scale=0.1)
    w_pr, b_pr = randn(d_ff, width, scale=d_ff ** -0.5), randn(width, scale=0.1)
    qkv_args = (x, ln_s, ln_b, w[0], b[0], w[1], b[1], w[2], b[2],
                (width // heads) ** -0.5)
    q, k, v = fab.fused_ln_qkv(*qkv_args)
    cases = {
        "fused_ln_qkv": (fab.fused_ln_qkv, fab.fused_ln_qkv_plain, qkv_args),
        "attention_core_oproj": (fab.attention_core_oproj,
                                 fab.attention_core_oproj_plain,
                                 (x, q, k, v, w[3], b[3], heads)),
        "fused_mlp_block": (fab.fused_mlp_block, fab.fused_mlp_block_plain,
                            (x, ln_s, ln_b, w_fc, b_fc, w_pr, b_pr)),
    }
    run_cases(cases, batch)
    act = batch * seq * width * 2
    print(f"attention_core_oproj B={batch}: attention stage alone "
          f"{cuda_ms(lambda: fab.attention_core(q, k, v, heads), 10)} ms")
    attention_route_bound("attention_core_oproj", batch, seq, width, heads,
                          5 * act + width * width * 2 + width * 2,
                          2 * batch * seq * width * width)


def run_cases(cases: dict, batch: Optional[int] = None) -> None:
    """Each case once against its plain version, then timed; the names
    carry the batch unless ``batch`` is given."""
    for name, (fn, plain, args) in cases.items():
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max((g.float() - p.float()).abs().max().item()
                  for g, p in zip(got, want))
        differ = sum(int((g != p).sum()) for g, p in zip(got, want))
        label = name if batch is None else f"{name} B={batch}"
        print(f"{label}: max abs err {err}, {differ} of "
              f"{sum(g.numel() for g in got)} elements differ, "
              f"{cuda_ms(lambda: fn(*args), 10)} ms")


def vit_q8_probe(randn) -> None:
    batch, cfg = 16, clip.CLIPVisionConfig.vit_l_14_336(num_layers=1)
    seq, width, heads = cfg.seq_len, cfg.width, cfg.num_heads
    d_ff = cfg.mlp_ratio * width
    blocks = {name: randn(1, *shape, scale=shape[0] ** -0.5)
              for name, shape in (("q", (width, width)), ("k", (width, width)),
                                  ("v", (width, width)), ("o", (width, width)),
                                  ("mlp_fc", (width, d_ff)),
                                  ("mlp_proj", (d_ff, width)))}
    q8 = clip.quantize_vision_blocks({"blocks": blocks})
    x = randn(batch, seq, width)
    ln_s, ln_b = 1 + randn(width, scale=0.1), randn(width, scale=0.1)
    b_qkv, b_fc, b_pr = (randn(n, scale=0.1)
                         for n in (3 * width, d_ff, width))
    qkv_args = (x, ln_s, ln_b, q8["qkv"][0], q8["qkv_scale"][0], b_qkv,
                (width // heads) ** -0.5)
    q, k, v = fab.fused_qkv_q8(*qkv_args)
    cases = {
        "fused_qkv_q8": (fab.fused_qkv_q8, fab.fused_qkv_q8_plain, qkv_args),
        "attention_core": (fab.attention_core, fab.attention_core_plain,
                           (q, k, v, heads)),
        "attention_core fast_exp": (
            lambda *a: fab.attention_core(*a, fast_exp=True),
            lambda *a: fab.attention_core_plain(*a, fast_exp=True),
            (q, k, v, heads)),
        "fused_mlp_block_q8": (
            fab.fused_mlp_block_q8, fab.fused_mlp_block_q8_plain,
            (x, ln_s, ln_b, q8["mlp_fc"][0], q8["mlp_fc_scale"][0], b_fc,
             q8["mlp_proj"][0], q8["mlp_proj_scale"][0], b_pr)),
    }
    run_cases(cases, batch)
    attention_route_bound("attention_core", batch, seq, width, heads,
                          4 * batch * seq * width * 2)


def whole_block_probe(randn, cfg, orders: dict, short: bool = False) -> None:
    """fused_vit_block on 16 images of ``cfg`` in each named softmax order;
    with ``short``, also fused_vit_block_q8 and fused_attention_block."""
    batch, seq, width, heads = 16, cfg.seq_len, cfg.width, cfg.num_heads
    layer = {name: leaf[0] for name, leaf in clip.init_clip_vision_params(
        torch.Generator(device="cuda").manual_seed(1), cfg)["blocks"].items()}
    x = randn(batch, seq, width)
    block = [layer[n] for n in (
        "ln1_scale", "ln1_bias", "q", "q_bias", "k", "k_bias", "v", "v_bias",
        "o", "o_bias", "ln2_scale", "ln2_bias", "mlp_fc", "mlp_fc_bias",
        "mlp_proj", "mlp_proj_bias")]
    cases = {
        f"fused_vit_block {name} L={seq}": (
            lambda *a, kw=kw: fab.fused_vit_block(*a, **kw),
            lambda *a, kw=kw: fab.fused_vit_block_plain(*a, **kw),
            (x, *block, heads))
        for name, kw in orders.items()}
    if short:
        q8 = clip.quantize_vision_blocks(
            {"blocks": {n: layer[n][None] for n in (
                "q", "k", "v", "o", "mlp_fc", "mlp_proj")}})
        b_qkv = torch.cat([layer["q_bias"], layer["k_bias"], layer["v_bias"]])
        cases["fused_vit_block_q8"] = (
            fab.fused_vit_block_q8, fab.fused_vit_block_q8_plain,
            (x, layer["ln1_scale"], layer["ln1_bias"], q8["qkv"][0],
             q8["qkv_scale"][0], b_qkv, q8["o"][0], q8["o_scale"][0],
             layer["o_bias"], layer["ln2_scale"], layer["ln2_bias"],
             q8["mlp_fc"][0], q8["mlp_fc_scale"][0], layer["mlp_fc_bias"],
             q8["mlp_proj"][0], q8["mlp_proj_scale"][0],
             layer["mlp_proj_bias"], heads))
        cases["fused_attention_block"] = (
            lambda *a: fab.fused_attention_block(*a, block_diag=True),
            lambda *a: fab.fused_attention_block_plain(*a, block_diag=True),
            (x, *(layer[n] for n in ("q", "q_bias", "k", "k_bias", "v",
                                     "v_bias", "o", "o_bias")), heads))
    run_cases(cases, batch)



def clipcap_probe(randn) -> None:
    """fused_gpt2_block and flash_attention against their plain versions."""
    cfg = gpt2.GPT2Config.gpt2_small(num_layers=1)
    layer = {name: leaf[0] for name, leaf in gpt2.init_gpt2_params(
        torch.Generator(device="cuda").manual_seed(2), cfg)["blocks"].items()}
    for name in layer:
        if name.endswith(("bias", "scale")):
            base = 1.0 if name.endswith("scale") else 0.0
            layer[name] = (base + randn(*layer[name].shape, scale=0.1)
                           ).bfloat16()
    params = [layer[n] for n in fab.GPT2_BLOCK_KEYS]
    cases = {}
    for batch, seq, left in ((32, 64, 0), (6, 64, 7)):
        x = randn(batch, seq, cfg.d_model)
        mask = torch.ones((batch, seq), dtype=torch.int32, device="cuda")
        for b in range(batch):
            mask[b, seq - b % 9:] = 0
        mask[1, :left] = 0
        cases[f"fused_gpt2_block B={batch} L={seq} left pad {left}"] = (
            fab.fused_gpt2_block, fab.fused_gpt2_block_plain,
            (x, mask, *params, cfg.num_heads))
    q, k, v = (randn(16, 577, 16, 64, scale=s) for s in (0.125, 1, 1))
    cases["flash_attention B=16 L=577"] = (
        attn.flash_attention, attn.flash_attention_plain, (q, k, v))
    q, k, v = (randn(3, 70, 4, 64, scale=s) for s in (0.125, 1, 1))
    key_mask = torch.zeros((3, 1, 1, 70), device="cuda")
    key_mask[1, ..., 30:] = -1e9
    key_mask[2] = -1e9                      # a row the bias masks entirely
    cases["flash_attention key-mask bias"] = (
        attn.flash_attention, attn.flash_attention_plain,
        (q, k, v, key_mask))
    cases["flash_attention per-(batch, head) bias"] = (
        attn.flash_attention, attn.flash_attention_plain,
        (q, k, v, randn(3, 4, 70, 70).float()))
    run_cases(cases)


def flash_reference() -> None:
    """flash_attention and its plain version on 2 images at ViT-L/14@336's
    attention (577 tokens, 16 heads of 64), each against an fp64
    reference: how many outputs part from the plain version's by more than
    one bf16 ulp of the plain value, and how many of each lie beyond one
    ulp of the fp64 value."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = (randn(2, 577, 16, 64) * 0.125).bfloat16()
    k, v = randn(2, 577, 16, 64).bfloat16(), randn(2, 577, 16, 64).bfloat16()
    got = attn.flash_attention(q, k, v).double()
    want = attn.flash_attention_plain(q, k, v).double()
    q64, k64, v64 = (t.double().transpose(1, 2) for t in (q, k, v))
    e = torch.softmax(q64 @ k64.transpose(-1, -2), dim=-1)
    ref = (e @ v64).transpose(1, 2)

    def ulp(a):
        return torch.exp2(torch.floor(torch.log2(
            a.abs().clamp_min(2.0 ** -126))) - 7)

    strict = (got - want).abs() > ulp(want)
    print(f"flash_attention vs plain: {int((got != want).sum())} of "
          f"{got.numel()} differ, {int(strict.sum())} by more than one ulp "
          f"of the plain value; rms(plain) {want.square().mean().sqrt()}")
    for name, out in (("kernel", got), ("plain", want)):
        far = (out - ref).abs() > ulp(ref)
        print(f"{name} vs fp64: {int(far.sum())} beyond one ulp of fp64, "
              f"max abs err {(out - ref).abs().max().item()}")
    for i in strict.nonzero()[:12].tolist():
        i = tuple(i)
        print(f"  at {i}: kernel {got[i].item()}, plain {want[i].item()}, "
              f"fp64 {ref[i].item()}")



def attention_variants(dirs: List[Path]) -> None:
    """attention_core's kernel from each csrc copy in ``dirs``: built in
    parallel (one process each), then checked and timed in turns."""
    built = build_variants(dirs, ["vit_block"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch, seq, width, heads = 256, 577, 1024, 16
    q, k, v = (torch.randn((batch, seq, width), generator=gen, device="cuda")
               .mul_(s).bfloat16() for s in (0.5, 2.0, 1.0))
    want = {fe: fab.attention_core_plain(q, k, v, heads, fast_exp=fe).float()
            for fe in (False, True)}
    for d in built + built[::-1]:
        kernels.CSRC_DIR = d
        kernels._loaded.clear()
        parts = []
        for fe in (False, True):
            got = fab.attention_core(q, k, v, heads, fast_exp=fe).float()
            err = (got - want[fe]).abs()
            ok = bool((err <= 8e-3 * (1 + want[fe].abs())).all())
            ms = cuda_ms(lambda: fab.attention_core(q, k, v, heads,
                                                    fast_exp=fe), 10)
            parts.append(f"fast_exp={fe}: within 8e-3 (1 + |want|) {ok}, "
                         f"{(err > 0).float().mean().item()} of the outputs "
                         f"differ, {ms} ms")
        print(f"{d}: " + "; ".join(parts), flush=True)


def within_one_ulp(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(every element within one bf16 ulp of the larger of the two values,
    at least that of rms(want) / 256; the share of elements that differ)."""
    g, w = got.float(), want.float()
    top = torch.maximum(torch.maximum(g.abs(), w.abs()),
                        w.square().mean().sqrt() / 256)
    err = (g - w).abs()
    return (bool((err <= torch.exp2(torch.floor(torch.log2(top)) - 7)).all()),
            (err > 0).float().mean().item())


def flash_variants(dirs: List[Path]) -> None:
    """flash_attention's kernel from each csrc copy in ``dirs``: built in
    parallel (one process each), checked against the plain version on 16
    images at ViT-L/14@336's attention and at head size 128, then timed on
    256 images in turns (the list, then reversed)."""
    built = build_variants(dirs, ["flash_attention"])
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(batch, heads, dh):
        q, k, v = (torch.randn((batch, 577, heads, dh), generator=gen,
                               device="cuda") for _ in range(3))
        return (q * dh ** -0.5).bfloat16(), k.bfloat16(), v.bfloat16()

    checks = {"B=16 dh=64": qkv(16, 16, 64), "B=2 dh=128": qkv(2, 8, 128)}
    want = {name: attn.flash_attention_plain(*a) for name, a in checks.items()}
    timed = qkv(256, 16, 64)
    for d in built + built[::-1]:
        kernels.CSRC_DIR = d
        kernels._loaded.clear()
        parts = []
        for name, args in checks.items():
            ok, share = within_one_ulp(attn.flash_attention(*args), want[name])
            parts.append(f"{name}: within one ulp {ok}, {share} differ")
        ms = cuda_ms(lambda: attn.flash_attention(*timed), 10)
        print(f"{d}: " + "; ".join(parts) + f"; B=256 {ms} ms", flush=True)


def build_variants(dirs: List[Path], names: List[str]) -> List[Path]:
    """Builds ``names`` from each csrc copy in ``dirs``, one process each,
    all at once, and prints each build's ptxas wgmma serialization warnings
    (C75xx), spill stores and registers by entry function; returns the
    copies that built."""
    build = ("from pathlib import Path\n"
             "from explicit_alignment_for_vqa_tasks_tpu_torch import kernels\n"
             "kernels.CSRC_DIR = Path({!r})\n"
             "logs = kernels.build({!r}, ptxas_verbose=True)\n"
             "print('\\n'.join(logs.values()))\n")
    procs = {d: subprocess.Popen(
        [sys.executable, "-c", build.format(str(d), names)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for d in dirs}
    built = []
    for d, proc in procs.items():
        log, _ = proc.communicate()
        warnings = sorted(set(re.findall(r"C75[0-9][0-9]", log)))
        print(f"{d}: build exit {proc.returncode}, serialization warnings "
              f"{warnings}", flush=True)
        entry = None
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                entry = found.group(1)
            used = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores", line)
            if entry and (used or spill):
                print(f"  {entry[:90]}: {line.split(':', 1)[-1].strip()}")
            if "C75" in line or "error" in line:
                print(f"  {line.strip()[:200]}")
        if proc.returncode == 0:
            built.append(d)
    return built


def oproj_case(rows: int, groups: int, depth: int, width: int) -> tuple:
    """fused_oproj_residual_q8's arguments from a seeded generator: bf16
    residual and attention output, weights (groups x depth, width) from the
    T5 quantizer."""
    gen = torch.Generator(device="cuda").manual_seed(rows + 7 * groups
                                                     + depth + width)
    inner = groups * depth
    x = (torch.randn((1, rows, width), generator=gen, device="cuda") * 2
         ).bfloat16()
    attn = torch.randn((1, rows, inner), generator=gen, device="cuda"
                       ).bfloat16()
    q, s = _quant_stacked_i8(torch.randn(
        (1, inner, width), generator=gen, device="cuda") * inner ** -0.5,
        groups)
    return x, attn, q[0], s[0]


# --q8-variants: fused_oproj_residual_q8's edges (rows below one tile, a
# ragged 128-row tile and the main path's; groups of 64, 128 and 256 bytes
# in 1, 2 and 8 groups; widths of one and two 128-column tiles and more)
# and fused_vit_block_q8's (1, 3 and 16 images at three widths)
Q8_ROWS = (64, 800, 32 * 557)
Q8_GROUPS = tuple((g, depth) for g in (1, 2, 8) for depth in (64, 128, 256))
Q8_WIDTHS = (128, 256, 768, 2048, 2304)
VIT_Q8_BATCHES = (1, 3, 16)
VIT_Q8_WIDTHS = ((768, 12), (640, 10), (128, 2))


def q8_variants(dirs: List[Path]) -> None:
    """fused_oproj_residual_q8 and fused_vit_block_q8 built from each csrc
    copy in ``dirs`` (in parallel, with their ptxas reports): a SHA-256 of
    each over the edge sweep, whether the copies agree bit for bit and
    their outputs that differ from plain, then every int8 kernel timed at
    int8_cases' main shapes in turns (the list, then reversed), with each
    CUDA kernel's device ms under the profiler. The wrappers are this
    tree's: the copies must keep its launchers' signatures."""
    fab.vit_attention_max_len(64)  # vit_block from this tree, cached
    built = build_variants(dirs, ["int8_encoder", "vit_block_q8"])
    oproj = {(m, g, d, n): oproj_case(m, g, d, n) for m in Q8_ROWS
             for g, d in Q8_GROUPS for n in Q8_WIDTHS}
    vit = {(b, w): vit_block_q8_case(clip.CLIPVisionConfig.vit_b_32(
        num_layers=1, width=w, num_heads=h), b)
        for b in VIT_Q8_BATCHES for w, h in VIT_Q8_WIDTHS}
    plain_oproj = {k: fab.fused_oproj_residual_q8_plain(*a)
                   for k, a in oproj.items()}
    digests = {}
    for d in built:
        kernels.CSRC_DIR = d
        kernels._loaded.clear()
        per_case, differ = {}, 0
        for key, args in oproj.items():
            out = fab.fused_oproj_residual_q8(*args)
            per_case[("oproj", *key)] = sha256_of([out])
            differ += int((out != plain_oproj[key]).sum())
        for key, args in vit.items():
            per_case[("vit", *key)] = sha256_of(
                [fab.fused_vit_block_q8(*args, group=1)])
        digests[d] = per_case
        total = hashlib.sha256("".join(per_case.values()).encode())
        print(f"{d}: {len(per_case)} cases, sweep sha256 "
              f"{total.hexdigest()}, fused_oproj_residual_q8 outputs off "
              f"plain {differ}", flush=True)
    if len(digests) > 1:
        first = next(iter(digests.values()))
        for d, per_case in digests.items():
            off = [k for k, v in per_case.items() if v != first[k]]
            print(f"{d}: {len(off)} cases differ from {built[0]}: "
                  f"{off[:12]}", flush=True)
    del oproj, vit, plain_oproj
    main = int8_cases(256, 1024)
    for d in built + built[::-1]:
        kernels.CSRC_DIR = d
        kernels._loaded.clear()
        int8_times(main, f"{d}: ")


if __name__ == "__main__":
    main()
