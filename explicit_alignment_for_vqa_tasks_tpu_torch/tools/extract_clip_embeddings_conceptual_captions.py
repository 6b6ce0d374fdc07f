"""Conceptual Captions CLIP extraction: threaded downloads feeding batched
encodes on the card, writing the clip_embeddings parquet that
DataLoaderConceptualCaptions reads.

Counterpart of
explicit_alignment_for_vqa_tasks_tpu/tools/extract_clip_embeddings_conceptual_captions.py
(reference: src/tools/extract_clip_embeddings_conceptual_captions.py:21-125:
20 download threads, batch-512 CLIP encode, caption period normalization).
Output schema: columns image_url, caption, clip_embeddings.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.\
extract_clip_embeddings_conceptual_captions --split train --out cc.parquet

``--int8`` encodes through the int8 tower (``ClipImageEncoder(int8=True)``:
``fused_qkv_q8``, ``attention_core`` and ``fused_mlp_block_q8`` at
ViT-L/14@336). ``main`` imports the HF ``datasets`` loader only when run.
"""

from __future__ import annotations

import argparse
import io
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from ..device import rank
from ..parallel.multihost import maybe_initialize_distributed
from .clip_encoder import ClipImageEncoder, preprocess_image

logger = logging.getLogger(__name__)


def normalize_caption(caption: str) -> str:
    """Ensure the caption ends with ' .' (reference: :91-97)."""
    caption = caption.strip()
    if caption.endswith("."):
        caption = caption[:-1].strip()
    return caption + " ."


def fetch_single_image(url: str, timeout: float = 5.0) -> Optional[np.ndarray]:
    """Download one image (reference: :29-40). Returns HWC uint8 or None."""
    import urllib.request

    from PIL import Image

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            data = resp.read()
        with Image.open(io.BytesIO(data)) as img:
            return np.asarray(img.convert("RGB"))
    except Exception as exc:
        logger.debug("failed to fetch %s: %s", url, exc)
        return None


def extract_rows(
    rows: List[dict],
    out_path: str,
    encoder: Optional[ClipImageEncoder] = None,
    batch_size: int = 512,
    num_threads: int = 20,
    fetch=fetch_single_image,
) -> int:
    """rows: [{"image_url": str, "caption": str}]. Downloads in threads,
    encodes in fixed batches, writes parquet. Returns #rows written."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    encoder = encoder or ClipImageEncoder(batch_size=batch_size)
    image_size = encoder.cfg.image_size

    urls_out, captions_out, embeddings_out = [], [], []
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        for start in range(0, len(rows), batch_size):
            chunk = rows[start:start + batch_size]
            images = list(pool.map(lambda r: fetch(r["image_url"]), chunk))
            kept = [(r, img) for r, img in zip(chunk, images)
                    if img is not None]
            if not kept:
                continue
            batch = np.stack([
                preprocess_image(img, image_size) for _, img in kept
            ])
            embeddings = encoder.encode_batch(batch)
            for (row, _), emb in zip(kept, embeddings):
                urls_out.append([row["image_url"]])
                captions_out.append([normalize_caption(row["caption"])])
                embeddings_out.append(emb.astype(np.float32).tolist())
            logger.info("encoded %d/%d", len(urls_out), len(rows))

    if rank() == 0:  # one writer over a mesh of processes
        table = pa.table({
            "image_url": urls_out,
            "caption": captions_out,
            "clip_embeddings": embeddings_out,
        })
        pq.write_table(table, out_path)
        logger.info("wrote %d rows to %s", len(urls_out), out_path)
    return len(urls_out)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--split", default="train",
                        choices=["train", "validation"])
    parser.add_argument("--out", required=True)
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--num_threads", type=int, default=20)
    parser.add_argument(
        "--int8", action="store_true",
        help="int8 bulk-extraction mode: the blocks' projections "
             "quantized per output channel, activations per row",
    )
    parser.add_argument(
        "--mesh_data", type=int, default=1,
        help="processes (one a card, started by torchrun) to shard each "
             "encode batch over: 0 or 1 one card, -1 every process; the "
             "batch size must divide by it, rank 0 writes the output",
    )
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)

    import datasets  # HF datasets hub loader (reference: :100-105)

    maybe_initialize_distributed()

    ds = datasets.load_dataset("conceptual_captions", split=args.split)
    rows = [
        {"image_url": r["image_url"], "caption": r["caption"]}
        for r in (ds if not args.limit else ds.select(range(args.limit)))
    ]
    encoder = ClipImageEncoder(batch_size=args.batch_size, int8=args.int8,
                               mesh=args.mesh_data)
    extract_rows(rows, args.out, encoder=encoder,
                 batch_size=args.batch_size,
                 num_threads=args.num_threads)


if __name__ == "__main__":
    main()
