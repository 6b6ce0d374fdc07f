"""Visualize a val question's in-context example images + test image grid
(reference: src/tools/visualise_in_context_examples.py:17-37).

Counterpart of
explicit_alignment_for_vqa_tasks_tpu/tools/visualise_in_context_examples.py,
host code only, over a ``rices.pkl``. Needs ``matplotlib`` and ``PIL``,
imported where it draws.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

logger = logging.getLogger(__name__)


def visualise(
    question_id: str,
    in_context_examples_path: str,
    train_image_dir: str,
    val_image_dir: str,
    test_img_key: int,
    out_path: str,
    num_shots: int = 4,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    with open(in_context_examples_path, "rb") as fh:
        examples_by_qid = pickle.load(fh)
    examples = examples_by_qid[str(question_id)][-num_shots:]

    fig, axes = plt.subplots(1, num_shots + 1,
                             figsize=(3 * (num_shots + 1), 3))
    for ax, example in zip(axes[:-1], examples):
        path = os.path.join(
            train_image_dir,
            f"COCO_train2014_{str(example['img_key']).zfill(12)}.jpg",
        )
        ax.imshow(Image.open(path))
        ax.set_title(
            f"{example['question']}\n{example['gold_answer']}", fontsize=6
        )
        ax.axis("off")
    test_path = os.path.join(
        val_image_dir, f"COCO_val2014_{str(test_img_key).zfill(12)}.jpg"
    )
    axes[-1].imshow(Image.open(test_path))
    axes[-1].set_title("test image", fontsize=6)
    axes[-1].axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    logger.info("saved grid to %s", out_path)
    return out_path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--question_id", required=True)
    parser.add_argument("--in_context_examples", required=True)
    parser.add_argument("--train_image_dir", required=True)
    parser.add_argument("--val_image_dir", required=True)
    parser.add_argument("--test_img_key", type=int, required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--num_shots", type=int, default=4)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    visualise(args.question_id, args.in_context_examples,
              args.train_image_dir, args.val_image_dir, args.test_img_key,
              args.out, args.num_shots)


if __name__ == "__main__":
    main()
