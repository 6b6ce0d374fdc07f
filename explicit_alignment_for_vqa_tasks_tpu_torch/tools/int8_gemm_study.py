"""Where a fused_t5_ln_qkv_q8 call spends its device time, by CUDA kernel.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.int8_gemm_study

Runs the wrapper at T0-3B widths (D = inner = 2048) on random bf16 inputs
and weights from the port's quantizer, at 32 x 557 rows with 8, 2 and 1
contraction groups and at a quarter of the rows with 8, and prints one JSON
line per case: the mean device ms per call of each CUDA kernel it launched
(torch.profiler over 10 calls after 3 warm-up calls). The group count
separates the per-group fp32 fold from the int8 product; the row count
shows how the time scales. Needs one CUDA card; prints the card's name
and power limit first.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from .. import kernels
from ..models.t5 import _quant_stacked_i8
from ..ops.fused_attention_block import fused_t5_ln_qkv_q8

ROWS, WIDTH, CALLS = 32 * 557, 2048, 10


def profile_case(gen: torch.Generator, x: torch.Tensor, groups: int) -> dict:
    lnw = torch.ones(WIDTH, device=x.device, dtype=torch.bfloat16)
    weights = []
    for _ in range(3):
        w = torch.randn(1, WIDTH, WIDTH, generator=gen, device=x.device)
        q, s = _quant_stacked_i8(w * WIDTH ** -0.5, groups)
        weights += [q[0], s[0]]
    for _ in range(3):
        fused_t5_ln_qkv_q8(x, lnw, *weights)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fused_t5_ln_qkv_q8(x, lnw, *weights)
        torch.cuda.synchronize()
    per_kernel = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            name = event.name[:60]
            per_kernel[name] = (per_kernel.get(name, 0.0)
                                + event.time_range.elapsed_us() / CALLS / 1e3)
    return dict(rows=x.shape[1], groups=groups, ms_per_call=per_kernel)


def main() -> int:
    if not torch.cuda.is_available():
        print("int8_gemm_study: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    kernels.build(["int8_encoder"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(1, ROWS, WIDTH, generator=gen, device="cuda") * 2
         ).bfloat16()
    for rows, groups in ((ROWS, 8), (ROWS, 2), (ROWS, 1), (ROWS // 4, 8)):
        case = profile_case(gen, x[:, :rows].contiguous(), groups)
        print(json.dumps(case), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
