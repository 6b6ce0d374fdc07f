"""What ``vit_b_study`` and ``vit_l_study`` share: the CLI, the timed
encodes and component towers, the layer functions the towers stack, and the
analytic FLOP split.

Timing follows the JAX studies: a timed call runs ``k`` encodes (or ``k``
passes of a layer stack), then ``torch.cuda.synchronize``; one warm call,
then the best of ``--trials`` calls, divided by ``k``. Each tower chains
``k`` passes of the model's depth of one layer function, each layer's
output the next one's input, as the JAX towers' two scans do.

In the port, a kernel's ``group`` (images per TPU program) is checked and
does not change the program; ``fused_mlp_block`` has no ``chunks`` (a TPU
VMEM measure). Entries of the JAX tables that differ from a timed one only
there are reported as ``{"same_program_as": "<timed name>"}``.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback
from typing import Callable, Dict, Optional, Union

import torch

from ..models.clip import CLIPVisionConfig, _layer_norm, _layers, \
    clip_encode_image
from ..ops import fused_attention_block as fab

# a table's entry: a callable that runs one timed call and returns a tensor
# to read, or the name of the timed entry whose program it runs
Entry = Union[Callable[[], torch.Tensor], str]


def parse_args(argv, description: str) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--variants", default="",
                        help="comma filter of end-to-end variants to run")
    parser.add_argument("--towers", default="",
                        help="comma filter of component towers; 'none' "
                        "skips them")
    parser.add_argument("--trials", type=int, default=3,
                        help="timed calls after the warm one; the best "
                        "counts")
    parser.add_argument("--device", default=None,
                        help="the card unless given (cpu: plain versions)")
    return parser.parse_args(argv)


def pick(table: Dict[str, Entry], names: str) -> Dict[str, Entry]:
    """The JAX filter: "" keeps every entry, "none" none, else the named."""
    if names == "none":
        return {}
    if not names:
        return table
    want = {n for n in names.split(",") if n}
    return {k: v for k, v in table.items() if k in want}


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def timed(fn: Callable[[], torch.Tensor], trials: int, k: int,
          dev: torch.device) -> float:
    """Best seconds per ONE of the ``k`` inner iterations over ``trials``
    calls, after a warm call; each call's result is read on the host."""
    float(fn())
    best = float("inf")
    for _ in range(trials):
        t0 = _sync(dev)
        float(fn())
        best = min(best, _sync(dev) - t0)
    return best / k


def run_table(table: Dict[str, Entry], trials: int, k: int,
              dev: torch.device,
              fields: Callable[[str, float], dict]) -> Dict[str, dict]:
    """Each entry timed into ``fields(name, seconds)``, or its error
    recorded, or its ``same_program_as`` target named."""
    out: Dict[str, dict] = {}
    for name, fn in table.items():
        if isinstance(fn, str):
            out[name] = {"same_program_as": fn}
            continue
        try:
            out[name] = fields(name, timed(fn, trials, k, dev))
            print(f"{name:>24}: {out[name]}", file=sys.stderr)
        except Exception as exc:  # one entry's failure is its own result
            traceback.print_exc()
            out[name] = {"error": str(exc)[:300]}
    return out


def encoder(params: dict, cfg: CLIPVisionConfig,
            stacked: torch.Tensor) -> Callable[[], torch.Tensor]:
    """One timed call: each of the (K, B, H, W, 3) images' batches encoded,
    the embeddings summed in fp32."""
    @torch.inference_mode()
    def run() -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=stacked.device)
        for images in stacked:
            total += clip_encode_image(params, cfg, images).float().sum()
        return total
    return run


def tower(layer_fn: Callable, blocks: dict, x: torch.Tensor,
          k: int) -> Callable[[], torch.Tensor]:
    """One timed call: ``k`` passes of ``layer_fn`` over the stacked
    ``blocks``' layers, chained from ``x``; the output summed in fp32."""
    @torch.inference_mode()
    def run() -> torch.Tensor:
        y = x
        for _ in range(k):
            for layer_p in _layers(blocks):
                y = layer_fn(y, layer_p)
        return y.float().sum()
    return run


def flop_split(seq: int, width: int, d_ff: int) -> Dict[str, int]:
    """Analytic FLOPs of one layer for one image, by component."""
    return {
        "qkv": 3 * 2 * seq * width * width,
        "scores_pv": 2 * 2 * seq * seq * width,
        "o_proj": 2 * seq * width * width,
        "mlp": 2 * 2 * seq * width * d_ff,
    }


def layer_functions(num_heads: int, width: int, eps: float
                    ) -> Dict[str, Callable]:
    """The towers' layer functions, each ``fn(x, layer_p) -> y``, named as
    in the JAX studies (``_g`` and ``chunks`` suffixes dropped: they change
    no program here)."""
    head_dim = width // num_heads
    scale = head_dim ** -0.5
    bf = torch.bfloat16

    def linear(x, w):
        # the JAX einsum with preferred_element_type=float32, cast to bf16
        return torch.matmul(x, w.to(bf))

    def qkv_projections_xla(x, lp):
        ln1 = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps)
        q, k, v = (linear(ln1, lp[n]) for n in ("q", "k", "v"))
        return q + k + v  # keep all three live

    def whole_block(x, lp):
        return fab.fused_vit_block(
            x, *(lp[n] for n in (
                "ln1_scale", "ln1_bias", "q", "q_bias", "k", "k_bias", "v",
                "v_bias", "o", "o_bias", "ln2_scale", "ln2_bias", "mlp_fc",
                "mlp_fc_bias", "mlp_proj", "mlp_proj_bias")),
            num_heads=num_heads, group=1, eps=eps)

    def ln_qkv_fused(x, lp):
        q, k, v = fab.fused_ln_qkv(
            x, lp["ln1_scale"], lp["ln1_bias"], lp["q"], lp["q_bias"],
            lp["k"], lp["k_bias"], lp["v"], lp["v_bias"],
            scale=scale, group=1, eps=eps)
        return q + k + v

    def attention_core(x, lp):
        return fab.attention_core(x * scale, x, x, num_heads)

    def attention_core_fast_exp(x, lp):
        return fab.attention_core(x * scale, x, x, num_heads, fast_exp=True)

    def core_oproj(x, lp):
        return fab.attention_core_oproj(x, x * scale, x, x, lp["o"],
                                        lp["o_bias"], num_heads=num_heads)

    def mlp_fused(x, lp):
        return fab.fused_mlp_block(
            x, lp["ln2_scale"], lp["ln2_bias"], lp["mlp_fc"],
            lp["mlp_fc_bias"], lp["mlp_proj"], lp["mlp_proj_bias"],
            group=1, eps=eps)

    def attn_half_split(x, lp):
        # the split formulation: plain LN, q | k | v and out-projection
        # products around the attention core kernel
        ln1 = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps)
        q, k, v = (linear(ln1, lp[n]) + lp[n + "_bias"].to(bf)
                   for n in ("q", "k", "v"))
        attn = fab.attention_core(q * scale, k, v, num_heads)
        return x + linear(attn, lp["o"]) + lp["o_bias"].to(bf)

    def attn_half_split3(x, lp):
        q, k, v = fab.fused_ln_qkv(
            x, lp["ln1_scale"], lp["ln1_bias"], lp["q"], lp["q_bias"],
            lp["k"], lp["k_bias"], lp["v"], lp["v_bias"],
            scale=scale, group=1, eps=eps)
        return fab.attention_core_oproj(x, q, k, v, lp["o"], lp["o_bias"],
                                        num_heads=num_heads)

    return dict(
        qkv_projections_xla=qkv_projections_xla, whole_block=whole_block,
        ln_qkv_fused=ln_qkv_fused, attention_core=attention_core,
        attention_core_fast_exp=attention_core_fast_exp,
        core_oproj=core_oproj, mlp_fused=mlp_fused,
        attn_half_split=attn_half_split, attn_half_split3=attn_half_split3)


def tflops(flops_per_image: float, batch: int, seconds: float,
           ceiling: Optional[float]) -> dict:
    """The achieved rate and its share of the measured ceiling."""
    rate = flops_per_image * batch / seconds / 1e12
    return {"achieved_tflops_per_s": rate,
            "pct_of_measured_ceiling": (None if ceiling is None
                                        else 100 * rate / ceiling)}
