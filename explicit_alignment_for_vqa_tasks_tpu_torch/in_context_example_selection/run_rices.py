"""Run the full RICES pipeline from artifact files (CLI).

Counterpart of
explicit_alignment_for_vqa_tasks_tpu/in_context_example_selection/run_rices.py,
with its flags: the reference's 4 scripts run in order (reference
README.md:151-158), question kNN -> reformat -> image kNN -> joint ranking,
writing rices.pkl (or rices_questions_only.pkl with --question_only). The
kNN stages run on the card; ``main(argv, device="cpu")`` runs them on the
host. ``--mesh_data N`` (under ``torchrun --nproc_per_node N``, or -1 for
every process) splits the databases' rows over the processes; rank 0 writes
the same file one card writes.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.\
in_context_example_selection.run_rices --train_cache train.pkl \
        --val_cache val.pkl --train_text_embeddings tt.pkl \
        --val_text_embeddings vt.pkl --train_image_embeddings ti.pkl \
        --val_image_embeddings vi.pkl --out rices.pkl
"""

from __future__ import annotations

import argparse
import logging
import pickle
from typing import List, Optional

from ..device import DeviceLike

logger = logging.getLogger(__name__)


def _load_cache(path: str):
    with open(path, "rb") as fh:
        data = pickle.load(fh)
    if isinstance(data, dict) and "cache" in data:
        data = data["cache"]
    return data


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_cache", required=True)
    parser.add_argument("--val_cache", required=True)
    parser.add_argument("--train_text_embeddings", required=True)
    parser.add_argument("--val_text_embeddings", required=True)
    parser.add_argument("--train_image_embeddings", default="")
    parser.add_argument("--val_image_embeddings", default="")
    parser.add_argument("--out", required=True)
    parser.add_argument("--question_only", action="store_true")
    parser.add_argument("--k_questions", type=int, default=2048)
    parser.add_argument(
        "--mesh_data", type=int, default=1,
        help="processes to shard the kNN databases over (one a card, "
             "started by torchrun): 0 or 1 one card, -1 every process",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..parallel.mesh import make_data_mesh
    from ..parallel.multihost import maybe_initialize_distributed
    from .rices import run_full_pipeline

    maybe_initialize_distributed()

    train_items = _load_cache(args.train_cache)["data_items"]
    val_items = _load_cache(args.val_cache)["data_items"]
    run_full_pipeline(
        args.train_text_embeddings, args.val_text_embeddings,
        args.train_image_embeddings, args.val_image_embeddings,
        train_items, val_items, args.out,
        question_only=args.question_only, k_questions=args.k_questions,
        mesh=make_data_mesh(args.mesh_data), device=device,
    )


if __name__ == "__main__":
    main()
