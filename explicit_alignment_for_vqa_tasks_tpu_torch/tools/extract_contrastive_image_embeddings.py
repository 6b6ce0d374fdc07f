"""Extract per-image CLIP embeddings for VQA2, batched, on the card.

Counterpart of
explicit_alignment_for_vqa_tasks_tpu/tools/extract_contrastive_image_embeddings.py
with the same artifact: a pickle of ``{str(image_id): float32 [1,
proj_dim]}``, checkpointed every `checkpoint_every` images, which the VQA2
configs read (``configs/vqa2/base_env.jsonnet``).

Usage:
    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.\
extract_contrastive_image_embeddings \
        --question_file .../v2_OpenEnded_mscoco_val2014_questions.json \
        --image_dir .../val2014 --subtype val2014 --out embeddings.pkl
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
from typing import Dict, Iterable, Tuple

import numpy as np

from ..device import rank
from ..parallel.multihost import maybe_initialize_distributed
from .clip_encoder import ClipImageEncoder, preprocess_image

logger = logging.getLogger(__name__)


def iter_images(
    image_ids, image_dir: str, subtype: str, image_size: int
) -> Iterable[Tuple[int, np.ndarray]]:
    from PIL import Image

    for image_id in image_ids:
        filename = f"COCO_{subtype}_{str(image_id).zfill(12)}.jpg"
        path = os.path.join(image_dir, filename)
        if not os.path.exists(path):
            logger.warning("missing image %s", path)
            continue
        with Image.open(path) as img:
            arr = np.asarray(img.convert("RGB"))
        yield image_id, preprocess_image(arr, image_size)


def extract(
    question_file: str,
    image_dir: str,
    subtype: str,
    out_path: str,
    batch_size: int = 256,
    checkpoint_every: int = 10_000,
    encoder: ClipImageEncoder = None,
) -> Dict[str, np.ndarray]:
    with open(question_file, "r", encoding="utf-8") as fh:
        questions = json.load(fh)["questions"]
    image_ids = sorted({q["image_id"] for q in questions})
    logger.info("%d unique images to encode", len(image_ids))

    encoder = encoder or ClipImageEncoder(batch_size=batch_size)
    embeddings: Dict[str, np.ndarray] = {}
    for i, (image_id, emb) in enumerate(
        encoder.encode_iter(
            iter_images(image_ids, image_dir, subtype,
                        encoder.cfg.image_size)
        )
    ):
        embeddings[str(image_id)] = emb[None, :]  # (1, d) like the reference
        if (i + 1) % checkpoint_every == 0 and rank() == 0:
            with open(out_path, "wb") as fh:
                pickle.dump(embeddings, fh)
            logger.info("checkpointed %d embeddings", len(embeddings))
    if rank() == 0:  # one writer over a mesh of processes
        with open(out_path, "wb") as fh:
            pickle.dump(embeddings, fh)
        logger.info("wrote %d embeddings to %s", len(embeddings), out_path)
    return embeddings


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--question_file", required=True)
    parser.add_argument("--image_dir", required=True)
    parser.add_argument("--subtype", default="val2014")
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument(
        "--model_version", default="openai/clip-vit-large-patch14-336"
    )
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
    maybe_initialize_distributed()
    encoder = ClipImageEncoder(
        model_version=args.model_version, batch_size=args.batch_size,
        int8=args.int8, mesh=args.mesh_data,
    )
    extract(args.question_file, args.image_dir, args.subtype, args.out,
            batch_size=args.batch_size, encoder=encoder)


if __name__ == "__main__":
    main()
