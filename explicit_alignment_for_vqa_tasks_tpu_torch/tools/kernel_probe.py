"""A short first check of the bf16 kernels on the card, for the first chip
call after a kernel edit: build them with the compiler's register /
shared-memory / spill report, run each once against its plain version, and
time it.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.kernel_probe

Shapes: ``fused_t5_ffn`` at M = 32 x 557 rows, D = 2048, F = 5120 (gated),
with a SHA-256 of its bf16 output (the inputs come from a seeded generator,
so two builds of the kernel can be compared bit for bit);
``cross_attention_decode`` on layer 7 of 24 stacked (32, 557, 2048) bf16
caches; the CLIP ViT ``split3`` kernels (``fused_ln_qkv``,
``attention_core_oproj``, ``fused_mlp_block``) at ViT-L/14@336 widths on 16
images (L = 577, D = 1024, 16 heads, F = 4096). Prints one line per report
and per kernel; ``chip_smoke.py`` makes the full measurement.
"""

from __future__ import annotations

import hashlib

import torch

from .. import kernels
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: no CUDA device")
    logs = kernels.build(["cross_attention_decode", "t5_ffn", "vit_block"],
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
    torch.cuda.synchronize()
    print("fused_t5_ffn output sha256",
          hashlib.sha256(got.view(torch.int16).cpu().numpy().tobytes())
          .hexdigest())
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
    for name, (fn, plain, args) in cases.items():
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max((g.float() - p.float()).abs().max().item()
                  for g, p in zip(got, want))
        differ = sum(int((g != p).sum()) for g, p in zip(got, want))
        print(f"{name} B={batch}: max abs err {err}, {differ} of "
              f"{sum(g.numel() for g in got)} elements differ, "
              f"{cuda_ms(lambda: fn(*args), 10)} ms")


if __name__ == "__main__":
    main()
