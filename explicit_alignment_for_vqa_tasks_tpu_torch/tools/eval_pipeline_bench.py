"""The eval loop in two orders on the card: serial, and one deep.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/eval_pipeline_bench.py.
The JAX package's eval loop dispatches batch N+1's generate before it
collects batch N (fetch and detokenization on the host), so that the device
works while the host does; the port's ``BaseExecutor._eval_loop`` runs one
batch at a time. This tool times both orders over the port's
``_dispatch_generative`` / ``_collect_generative`` on the JAX tool's fixture
(``e2e_fixtures``: 32 val questions, 16 batches of 2, the two-layer T5 in
bf16 at the card's kernel widths), best of 3 each after one warm run, checks
that both give the same predictions and prints the speedup:

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.eval_pipeline_bench \\
        [--device cpu]

One JSON line follows, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..device import resolve_device
from ..utils.device_stats import device_info
from . import e2e_fixtures

VAL_QUESTIONS = 32
TRAIN_QUESTIONS = 6
TRIALS = 3


def run_serial(executor) -> List[Dict]:
    """Each batch generated and collected before the next is dispatched."""
    return [executor._generative_step(batch, i)
            for i, batch in enumerate(executor.test_dataloader)]


def run_pipelined(executor) -> List[Dict]:
    """JAX ``BaseExecutor._eval_loop``'s order (base_executor.py:439-449):
    batch N+1 dispatched before batch N is collected."""
    outputs: List[Dict] = []
    pending = None
    for i, batch in enumerate(executor.test_dataloader):
        state = executor._dispatch_generative(batch, i)
        if pending is not None:
            outputs.append(executor._collect_generative(pending))
        pending = state
    if pending is not None:
        outputs.append(executor._collect_generative(pending))
    return outputs


def predictions(outputs: List[Dict]) -> List[Dict]:
    return [p for out in outputs for p in out["predictions"]]


def bench(device: Optional[str] = None) -> dict:
    """Both orders on a fresh fixture; the result line's fields."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        fixtures = e2e_fixtures.write_vqa_fixtures(
            folder, n_train_imgs=TRAIN_QUESTIONS, n_val_imgs=VAL_QUESTIONS)
        config = e2e_fixtures.on_kernel_widths(
            e2e_fixtures.make_test_config(folder, fixtures))
        executor = e2e_fixtures.build_executor(config, device=dev)
        warm = predictions(run_pipelined(executor))
        best, outs = {}, {}
        for name, fn in (("serial", run_serial),
                         ("pipelined", run_pipelined)):
            best[name] = float("inf")
            for _ in range(TRIALS):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                out = fn(executor)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                best[name] = min(best[name], time.perf_counter() - t0)
            outs[name] = out
            print(f"{name}: {best[name] * 1e3:.0f} ms for {len(out)} "
                  f"batches ({len(predictions(out))} predictions)",
                  flush=True)
    serial, pipelined = (predictions(outs[n]) for n in ("serial",
                                                         "pipelined"))
    if not serial == pipelined == warm:
        raise RuntimeError("eval_pipeline_bench: the serial and pipelined "
                           "orders gave different predictions")
    speedup = best["serial"] / best["pipelined"]
    print(f"pipelining speedup: {speedup:.2f}x", flush=True)
    return {
        "metric": "eval_pipelining_speedup",
        "value": speedup,
        "serial_ms": best["serial"] * 1e3,
        "pipelined_ms": best["pipelined"] * 1e3,
        "batches": len(outs["serial"]),
        "predictions": len(serial),
        "config": {"val_questions": VAL_QUESTIONS,
                   "batch_size": int(config.valid.batch_size),
                   "trials": TRIALS,
                   "lm_config": config.model_config.lm_config},
        "device": device_info(dev),
    }


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="the card unless given (cpu: plain versions)")
    result = bench(parser.parse_args(argv).device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
