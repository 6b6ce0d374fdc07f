"""RICES at VQA2 scale, resident on the card.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/rices_at_scale.py.
The reference pipeline is 4 separate FAISS/pandas stages over pickles
(reference: src/in_context_example_selection/*, shapes from
get_question_knn.py:65-83: 443,757 train / 214,354 val questions, 768-d
CLIP embeddings, k=2048). Here the four stages of one validation chunk
(question top-k, image scoring within each question pool, joint ranking)
run on the card with the train matrices resident (1.36 GB of text, 0.25 GB
of images; a 1.82 GB score block a chunk of 1024), and only the final top
32 examples (chunk x 32) come back to the host. The products are true fp32
and every top-k breaks ties by the lowest index (ops/knn.py).

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.rices_at_scale

The embeddings are drawn on the card from seeded ``torch.Generator``s (the
host-to-card copy is not part of the metric). Prints one JSON line with
queries/s, the card's name and its power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, make_generator, resolve_device
from ..ops.knn import l2_normalize, top_k_lowest_index, true_fp32

Tensor = torch.Tensor


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_train", type=int, default=443_757)
    parser.add_argument("--n_val", type=int, default=214_354)
    parser.add_argument("--n_images", type=int, default=82_783)
    parser.add_argument("--dim", type=int, default=768)
    parser.add_argument("--k", type=int, default=2048)
    parser.add_argument("--top_examples", type=int, default=32)
    parser.add_argument("--query_chunk", type=int, default=1024)
    parser.add_argument("--max_chunks", type=int, default=0,
                        help="0 = all; >0 limits chunks (quick check)")
    parser.add_argument("--seed", type=int, default=0)
    return parser.parse_args(argv)


def make_database(args: argparse.Namespace, dev: torch.device
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """(train text (N, d), train images (U, d), each question's image
    index (N,)), normalized rows, drawn on ``dev`` from ``args.seed``."""
    gen = make_generator(args.seed, dev)
    train_text = l2_normalize(torch.randn(
        args.n_train, args.dim, generator=gen, device=dev))
    train_img = l2_normalize(torch.randn(
        args.n_images, args.dim, generator=gen, device=dev))
    img_idx = torch.randint(0, args.n_images, (args.n_train,),
                            generator=gen, device=dev)
    return train_text, train_img, img_idx


def make_queries(args: argparse.Namespace, chunk: int, dev: torch.device
                 ) -> Tuple[Tensor, Tensor]:
    """Validation chunk ``chunk``'s (text, image) queries, normalized."""
    gen = make_generator(args.seed + 1 + chunk, dev)
    shape = (args.query_chunk, args.dim)
    return (l2_normalize(torch.randn(shape, generator=gen, device=dev)),
            l2_normalize(torch.randn(shape, generator=gen, device=dev)))


def _run(name: str, fn):
    return fn()


def rices_chunk(train_text: Tensor, train_img: Tensor, img_idx: Tensor,
                q_text: Tensor, q_img: Tensor, k: int, top: int,
                stage=_run) -> Tuple[Tensor, Tensor]:
    """Stages 1-4 for one chunk: (joint similarities (C, top), train rows
    (C, top)), best first. ``stage(name, fn)`` runs each stage (``fn()``);
    ``stage_ms`` passes one that times it."""
    with true_fp32():
        s1 = stage("question_product", lambda: q_text @ train_text.T)
        q_sims, q_idx = stage("question_top_k",
                              lambda: top_k_lowest_index(s1, k))
        del s1                                              # (C, N)
        i_sims = stage("image_product_gather", lambda: (
            q_img @ train_img.T).gather(1, img_idx[q_idx]))  # (C, K)
        j_sims, j_pos = stage("joint_top_k", lambda: top_k_lowest_index(
            q_sims + i_sims, top))
        return j_sims, q_idx.gather(1, j_pos)


def stage_ms(args: argparse.Namespace,
             database: Tuple[Tensor, Tensor, Tensor],
             dev: torch.device) -> dict:
    """Chunk 0's stages timed one by one, each ending in a synchronize:
    the question product, its top-k, the image product and gather, the
    joint top-k (ms, host clock)."""
    def synchronize():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times = {}

    def timed(name, fn):
        synchronize()
        t0 = time.perf_counter()
        out = fn()
        synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    rices_chunk(*database, *make_queries(args, 0, dev), args.k,
                args.top_examples, stage=timed)
    return times


def bench(args: argparse.Namespace, database: Tuple[Tensor, Tensor, Tensor],
          dev: torch.device) -> dict:
    """Warm chunk 0, then run the chunks in order, each one's (C, 32)
    results fetched to the host, then chunk 0's stages one by one
    (``stage_ms``); returns the JSON line's fields and chunk 0's results
    (``first``)."""
    def synchronize():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    n_chunks = -(-args.n_val // args.query_chunk)
    if args.max_chunks:
        n_chunks = min(n_chunks, args.max_chunks)
    t0 = time.perf_counter()
    first = rices_chunk(*database, *make_queries(args, 0, dev), args.k,
                        args.top_examples)
    first = tuple(x.cpu() for x in first)
    warm_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out_sims, out_rows = [], []
    synchronize()
    t0 = time.perf_counter()
    for i in range(n_chunks):
        sims, rows = rices_chunk(*database, *make_queries(args, i, dev),
                                 args.k, args.top_examples)
        out_sims.append(sims.cpu().numpy())
        out_rows.append(rows.cpu().numpy())
    device_s = time.perf_counter() - t0
    # the reference's order: ascending, best example last
    all_sims = np.concatenate(out_sims)[:, ::-1]
    all_rows = np.concatenate(out_rows)[:, ::-1]
    n_queries = n_chunks * args.query_chunk
    stages = stage_ms(args, database, dev)
    return {
        "value": n_queries / device_s,
        "config": {
            "n_train": args.n_train, "n_val_processed": n_queries,
            "n_images": args.n_images, "dim": args.dim, "k": args.k,
            "top_examples": args.top_examples,
            "query_chunk": args.query_chunk, "chunks": n_chunks,
            "seconds": device_s, "warm_chunk_seconds": warm_s,
            "chunk_stage_ms": stages,
            "projected_full_val_minutes":
                args.n_val / (n_queries / device_s) / 60,
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
            "checksum": float(all_sims.sum()),
            "rows_shape": list(all_rows.shape),
        },
        "first": first,
    }


def report(result: dict, dev: torch.device) -> dict:
    """The JSON line of ``bench``'s result, beside the card's name and
    power limit."""
    from .bench_generate import device_info

    return {"metric": "rices_vqa2_scale_queries_per_sec",
            "value": result["value"], "unit": "queries/s",
            "device": device_info(dev), "config": result["config"]}


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(device)
    print(f"device: {dev}", file=sys.stderr)
    line = report(bench(args, make_database(args, dev), dev), dev)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
