"""Trace-backed accounting of the T5 greedy-decode step.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/decode_profile.py.
A child process (``--child DIR``) builds T0-3B with random weights on the
card, encodes a (batch, enc_len) batch of random embeddings once, times the
steady-state greedy decode, then records it under ``torch.profiler`` and
writes the chrome trace (traces run in processes of their own: late in a
long process a trace can lose records). This process parses the trace:
each device operation (CUDA kernel, memcpy, memset) is put into a bucket by
the outermost host operator that launched it and, where that names
nothing, by its own name:

  matmul              ``aten::matmul`` / ``mm`` / ``bmm`` / ``addmm`` /
                      ``linear`` / ``_int_mm``, GEMM kernels
  attention           ``aten::einsum`` (the step's attention products),
                      ``softmax``, attention kernels
  kv_update           the self-attention cache writes (a top-level
                      ``aten::copy_``, ``index_put_``, ``index_copy_``)
  fusion_elementwise  every other ``aten::`` operator (norms, adds,
                      activations, the greedy pick's reductions)
  layout              casts and copies (``aten::to``, ``contiguous``,
                      ``clone``, ``cat``), memcpy and memset
  other               the rest

and the idle gap: the span from the first operation's start to the last
one's end, less the union of the operations' intervals.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.decode_profile \\
        [--batch 16 --enc_len 557 --steps 20] [--int8_cross_kv] \\
        [--int8_decoder] [--int8_kv_layout auto|unmerged|merged|transposed]

Prints one JSON line: the untraced wall per step, the buckets in us and per
step, the idle share of the traced span and the busy share of the untraced
wall (the profiler slows the host, so the traced span is the longer), the
largest operations, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..device import make_generator, resolve_device
from ..models import t5 as t5_lib
from ..ops.decoding import greedy_decode_t5
from ..utils.device_stats import device_info

BUCKETS = ("matmul", "attention", "kv_update", "fusion_elementwise",
           "layout", "other")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
MATMUL_OPS = {"aten::matmul", "aten::mm", "aten::bmm", "aten::addmm",
              "aten::linear", "aten::_int_mm", "aten::baddbmm"}
ATTENTION_OPS = {"aten::einsum", "aten::softmax", "aten::_softmax",
                 "aten::scaled_dot_product_attention"}
KV_UPDATE_OPS = {"aten::copy_", "aten::index_put_", "aten::index_copy_",
                 "aten::slice_scatter"}
LAYOUT_OPS = {"aten::to", "aten::_to_copy", "aten::contiguous",
              "aten::clone", "aten::cat", "aten::stack"}


def bucket_of(name: str, op: str = "") -> str:
    """The bucket of a device operation ``name`` launched under the host
    operator ``op`` ("" where none encloses it)."""
    if op in MATMUL_OPS:
        return "matmul"
    if op in ATTENTION_OPS:
        return "attention"
    if op in KV_UPDATE_OPS:
        return "kv_update"
    if op in LAYOUT_OPS:
        return "layout"
    if op.startswith("aten::"):
        return "fusion_elementwise"
    n = name.lower()
    if "attention" in n or "softmax" in n:
        return "attention"
    if "gemm" in n or "gemv" in n or "matmul" in n:
        return "matmul"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "layout"
    if "elementwise" in n or "reduce" in n:
        return "fusion_elementwise"
    return "other"


def host_ops(events: List[dict]) -> Tuple[Dict[int, str], List[dict]]:
    """(each host operator's "External id" -> the name of the outermost
    ``cpu_op`` that encloses it on its thread, itself at the top; the
    top-level ``cpu_op`` events)."""
    outer: Dict[int, str] = {}
    top: List[dict] = []
    by_tid: Dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            by_tid.setdefault(e.get("tid"), []).append(e)
    for ops in by_tid.values():
        ops.sort(key=lambda e: (e["ts"], -e["dur"]))
        top_end, top_name = float("-inf"), ""
        for e in ops:
            if e["ts"] >= top_end:
                top_end, top_name = e["ts"] + e["dur"], e["name"]
                top.append(e)
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                outer[ext] = top_name
    return outer, top


def device_ops(trace: dict, categories=DEVICE_CATEGORIES
               ) -> List[Tuple[str, str, float, float]]:
    """(name, outermost host operator, start us, duration us) of each
    event of ``categories``. With ``("cpu_op",)``, a host-only trace's
    top-level operators stand for the device's operations."""
    events = trace.get("traceEvents", [])
    outer, top = host_ops(events)
    if tuple(categories) == ("cpu_op",):
        return [(e["name"], e["name"], e["ts"], e["dur"]) for e in top]
    # a kernel names its launch's "External id"; else its runtime call does
    runtime_ext = {e["args"]["correlation"]: e["args"].get("External id")
                   for e in events if e.get("cat") == "cuda_runtime"
                   and "correlation" in e.get("args", {})}
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in categories:
            continue
        args = e.get("args", {})
        ext = args.get("External id") or runtime_ext.get(
            args.get("correlation"))
        out.append((e["name"], outer.get(ext, ""), e["ts"], e["dur"]))
    return out


def summarize(ops: List[Tuple[str, str, float, float]], top: int = 12
              ) -> dict:
    """Buckets, busy time (the union of the intervals), span and idle gap,
    in us, and the ``top`` largest operations by name."""
    if not ops:
        raise ValueError("the trace holds no device operation")
    buckets = {b: 0.0 for b in BUCKETS}
    by_name: Dict[str, float] = {}
    for name, op, _, dur in ops:
        buckets[bucket_of(name, op)] += dur
        key = name[:80]
        by_name[key] = by_name.get(key, 0.0) + dur
    intervals = sorted((ts, ts + dur) for _, _, ts, dur in ops)
    busy, cur_start, cur_end = 0.0, intervals[0][0], intervals[0][1]
    for start, end in intervals[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    span = max(end for _, end in intervals) - intervals[0][0]
    idle = max(0.0, span - busy)
    return {
        "span_us": span, "busy_us": busy, "idle_us": idle,
        "idle_share": idle / span if span > 0 else 0.0,
        "summed_us": sum(buckets.values()),
        "buckets_us": buckets,
        "top_ops_us": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "n_events": len(ops),
    }


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--enc_len", type=int, default=557)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--trace_dir", default="",
                        help="keep the chrome trace here (default: a "
                             "temporary directory, removed)")
    parser.add_argument("--int8_cross_kv", action="store_true",
                        help="the int8 cross-KV decode")
    parser.add_argument("--int8_decoder", action="store_true",
                        help="weight-only int8 decode-step matmuls "
                             "(cfg.int8_decoder_step)")
    parser.add_argument("--int8_kv_layout", default="auto",
                        choices=["auto", "unmerged", "merged", "transposed"])
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card")
    parser.add_argument("--child", default="", help=argparse.SUPPRESS)
    return parser.parse_args(argv)


def run_child(args: argparse.Namespace) -> None:
    """Build, encode, time the decode untraced, then trace it; write
    ``trace.json`` and ``run.json`` into ``args.child``."""
    dev = resolve_device(args.device)
    cfg = t5_lib.T5Config.t0_3b(
        dtype=torch.bfloat16, int8_cross_kv=args.int8_cross_kv,
        int8_kv_layout=(None if args.int8_kv_layout == "auto"
                        else args.int8_kv_layout),
        int8_decoder_step=args.int8_decoder)
    params = t5_lib.init_t5_params(make_generator(0, dev), cfg,
                                   torch.bfloat16)
    if args.int8_decoder:
        params = t5_lib.quantize_decoder_step(params, drop_bf16=True)
    embeds = torch.randn((args.batch, args.enc_len, cfg.d_model),
                         generator=make_generator(1, dev), device=dev
                         ).to(torch.bfloat16)
    mask = torch.ones((args.batch, args.enc_len), dtype=torch.int32,
                      device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    with torch.inference_mode():
        hidden = t5_lib.t5_encode(params, cfg, inputs_embeds=embeds,
                                  attention_mask=mask)

        def decode():
            return greedy_decode_t5(params, cfg, hidden, mask, args.steps)

        tokens, _ = decode()  # warm
        sync()
        t0 = time.perf_counter()
        tokens, _ = decode()
        sync()
        wall = time.perf_counter() - t0
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            decode()
            sync()
    prof.export_chrome_trace(os.path.join(args.child, "trace.json"))
    finished = (tokens == cfg.eos_token_id).cumsum(1) > 0
    done = finished.all(0).nonzero()
    steps_run = int(done[0]) + 1 if len(done) else args.steps
    with open(os.path.join(args.child, "run.json"), "w") as fh:
        json.dump({"wall_s": wall, "steps_run": steps_run,
                   "device_type": dev.type, "device": device_info(dev)}, fh)


def report(folder: str, args: argparse.Namespace) -> dict:
    """The JSON line of the child's ``run.json`` and ``trace.json`` in
    ``folder``."""
    with open(os.path.join(folder, "run.json")) as fh:
        run = json.load(fh)
    with open(os.path.join(folder, "trace.json")) as fh:
        categories = (DEVICE_CATEGORIES if run["device_type"] == "cuda"
                      else ("cpu_op",))
        stats = summarize(device_ops(json.load(fh), categories))
    steps = run["steps_run"]
    return {
        "metric": "t5_decode_step_breakdown",
        "wall_ms_per_step": run["wall_s"] / steps * 1000,
        "trace": stats,
        "per_step_us": {k: v / steps for k, v in stats["buckets_us"].items()},
        "idle_share": stats["idle_share"],
        # the profiler slows the host, so the traced span outgrows the
        # untraced run: the device's busy time over the untraced wall
        "busy_share_of_untraced_wall": stats["busy_us"] / (run["wall_s"]
                                                           * 1e6),
        "config": {"int8_cross_kv": bool(args.int8_cross_kv),
                   "int8_decoder": bool(args.int8_decoder),
                   "int8_kv_layout": args.int8_kv_layout,
                   "batch": args.batch, "enc_len": args.enc_len,
                   "steps": args.steps, "steps_run": steps},
        "device": run["device"],
        "trace_dir": args.trace_dir or None,
    }


def main(argv: Optional[List[str]] = None, device=None) -> dict:
    args = parse_args(argv)
    if device is not None:
        args.device = str(device)
    if args.child:
        run_child(args)
        return {}
    folder = args.trace_dir or tempfile.mkdtemp(prefix="decode_trace_")
    os.makedirs(folder, exist_ok=True)
    try:
        child = [sys.executable, "-m",
                 "explicit_alignment_for_vqa_tasks_tpu_torch.tools."
                 "decode_profile", "--child", folder,
                 "--batch", str(args.batch), "--enc_len", str(args.enc_len),
                 "--steps", str(args.steps),
                 "--int8_kv_layout", args.int8_kv_layout]
        child += ["--int8_cross_kv"] * args.int8_cross_kv
        child += ["--int8_decoder"] * args.int8_decoder
        if args.device:
            child += ["--device", args.device]
        sys.stdout.flush()
        proc = subprocess.run(child, timeout=1800)
        if proc.returncode != 0:
            raise RuntimeError(
                f"decode_profile: the traced child failed (exit "
                f"{proc.returncode})")
        line = report(folder, args)
    finally:
        if not args.trace_dir:
            shutil.rmtree(folder, ignore_errors=True)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
