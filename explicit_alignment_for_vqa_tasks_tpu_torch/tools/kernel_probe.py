"""A short first check of the bf16 kernels on the card, for the first chip
call after a kernel edit: build them with the compiler's register /
shared-memory / spill report, run each once against its plain version, and
time it.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.kernel_probe
    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.kernel_probe \
        --int8-digests
    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.kernel_probe \
        --flash-reference

Shapes: ``fused_t5_ffn`` at M = 32 x 557 rows, D = 2048, F = 5120 (gated),
with a SHA-256 of its bf16 output (the inputs come from a seeded generator,
so two builds of the kernel can be compared bit for bit); the same digests
of the int8 T5 encoder kernels (``fused_t5_ln_qkv_q8``,
``fused_oproj_residual_q8``, ``fused_t5_ffn_q8``) at M = 32 x 557 rows,
D = inner = 2048, F = 5120, 8 contraction groups, with ``--int8-digests``
alone (that part needs only what the port had before the ViT int8 kernels,
so this file copied into an older tree digests that tree's build);
``cross_attention_decode`` on layer 7 of 24 stacked (32, 557, 2048) bf16
caches; the CLIP ViT ``split3`` kernels (``fused_ln_qkv``,
``attention_core_oproj``, ``fused_mlp_block``) and the int8 path's
(``fused_qkv_q8``, ``attention_core`` with and without ``fast_exp``,
``fused_mlp_block_q8``, weights from ``quantize_vision_blocks``) at
ViT-L/14@336 widths on 16 images (L = 577, D = 1024, 16 heads, F = 4096),
with ``fused_vit_block`` there too in its long ``whole`` and ``whole_dd``
orders; the short-sequence whole blocks (``fused_vit_block`` in its three
softmax orders, ``fused_vit_block_q8``, ``fused_attention_block``) at
ViT-B/32 widths on 16 images (L = 50, D = 768, 12 heads, F = 3072);
``fused_gpt2_block`` at GPT-2 small widths (D = 768, 12 heads, F = 3072) on
32 sequences of 64 positions (right-padded rows) and on 6 (a left-padded
row with no visible key, G = 2); ``flash_attention`` at ViT-L/14@336's
attention on 16 images (L = 577, 16 heads of 64, no bias) and on a small
shape under a key-mask and a per-(batch, head) bias; with
``--flash-reference`` alone, ``flash_attention`` and its plain version on 2
images at ViT-L/14@336's attention, each against an fp64 reference.
Prints one line per report and per kernel; ``chip_smoke.py`` makes the full
measurement.
"""

from __future__ import annotations

import hashlib
import sys
from typing import Optional

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


def sha256_of(outs) -> str:
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for out in outs:
        digest.update(out.view(torch.int16).cpu().numpy().tobytes())
    return digest.hexdigest()


def int8_encoder_digests() -> None:
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
    print("int8_encoder library", kernels.library_path("int8_encoder").name)
    print("fused_t5_ln_qkv_q8 output sha256",
          sha256_of(fab.fused_t5_ln_qkv_q8(x, lnw, *qkv)))
    print("fused_oproj_residual_q8 output sha256",
          sha256_of([fab.fused_oproj_residual_q8(x, attn, *o)]))
    print("fused_t5_ffn_q8 output sha256",
          sha256_of([fab.fused_t5_ffn_q8(x, lnw, *ffn)]), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: no CUDA device")
    if "--int8-digests" in sys.argv[1:]:
        int8_encoder_digests()
        return
    if "--flash-reference" in sys.argv[1:]:
        flash_reference()
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


if __name__ == "__main__":
    main()
