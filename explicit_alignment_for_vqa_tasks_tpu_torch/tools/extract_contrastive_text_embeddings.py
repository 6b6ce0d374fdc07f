"""Extract per-question CLIP text embeddings for VQA2, batched, on the card.

Counterpart of
explicit_alignment_for_vqa_tasks_tpu/tools/extract_contrastive_text_embeddings.py
(reference: src/tools/extract_contrastive_text_embeddings.py:15-72), with
its artifact: a pickle of ``{str(question_id): float32 [1, proj_dim]}``,
which RICES reads (in_context_example_selection/run_rices.py).

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.\
extract_contrastive_text_embeddings \
        --question_file .../v2_OpenEnded_mscoco_val2014_questions.json \
        --out val_text_embeddings.pkl

The questions are tokenized by the local HF CLIP tokenizer
(``ClipTextEncoder.tokenize``).
"""

from __future__ import annotations

import argparse
import json
import logging
import pickle
from typing import Dict

import numpy as np

from ..device import rank
from ..parallel.multihost import maybe_initialize_distributed
from .clip_encoder import ClipTextEncoder

logger = logging.getLogger(__name__)


def extract(
    question_file: str,
    out_path: str,
    batch_size: int = 512,
    encoder: ClipTextEncoder = None,
) -> Dict[str, np.ndarray]:
    with open(question_file, "r", encoding="utf-8") as fh:
        questions = json.load(fh)["questions"]
    encoder = encoder or ClipTextEncoder(batch_size=batch_size)
    embeddings: Dict[str, np.ndarray] = {}
    texts = [q["question"] for q in questions]
    qids = [q["question_id"] for q in questions]
    for start in range(0, len(texts), batch_size):
        chunk = encoder.encode_texts(texts[start:start + batch_size])
        for qid, emb in zip(qids[start:start + batch_size], chunk):
            embeddings[str(qid)] = emb[None, :]
    if rank() == 0:  # one writer over a mesh of processes
        with open(out_path, "wb") as fh:
            pickle.dump(embeddings, fh)
        logger.info("wrote %d text embeddings to %s", len(embeddings),
                    out_path)
    return embeddings


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--question_file", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument(
        "--model_version", default="openai/clip-vit-large-patch14-336"
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
    encoder = ClipTextEncoder(
        model_version=args.model_version, batch_size=args.batch_size,
        mesh=args.mesh_data,
    )
    extract(args.question_file, args.out, args.batch_size, encoder)


if __name__ == "__main__":
    main()
