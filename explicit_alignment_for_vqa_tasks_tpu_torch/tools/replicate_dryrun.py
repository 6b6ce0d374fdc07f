"""Dress rehearsal for the real-weights replication run (no downloads).

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/replicate_dryrun.py:
builds a complete tiny artifact set (a saved tiny HF T5 checkpoint wearing
the committed subword tokenizer fixture, a reference-style torch mapper
``.ckpt``, synthetic VQA2 questions and annotations, CLIP-embedding, RICES,
question-only RICES and RANDOM pickles), then drives
``tools/replicate_baseline.py`` through the whole published-table layout
(every ``--modes``: main x both templates, no_prefix, text_rices,
ensemble, random; reference: src/tools/plots_for_report.ipynb cells 2-7)
with the int8-vs-bf16 twin comparison and the trained-weight drift study.
It needs ``transformers`` (the tiny checkpoint and its tokenizer), so it
runs where that is installed; the model runs on the card unless
``--device cpu`` is given.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.replicate_dryrun \
        [--modes main --shots 0 --no-int8] [--device cpu]

``--poke-missing`` deletes one artifact first to show the missing-artifact
checklist.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import shutil
import sys
from pathlib import Path
from typing import Dict

from .e2e_fixtures import example_list, write_vqa_splits

logger = logging.getLogger(__name__)

PREFIX_SIZE = 16
PREFIX_LEN = 2
D_MODEL = 32
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOK_FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_t5_tokenizer")


def _write_vqa_artifacts(data_dir: str, n_train_imgs: int = 10,
                         n_val_imgs: int = 4) -> Dict[str, str]:
    """Synthetic VQA2 artifacts in the reference's exact file formats
    (``e2e_fixtures.write_vqa_splits``), with the main RICES, question-only
    RICES and RANDOM pickles."""
    import numpy as np

    files, train_qs, val_qs = write_vqa_splits(Path(data_dir), n_train_imgs,
                                               n_val_imgs)
    # ascending similarity (best LAST) — main RICES, question-only RICES
    # (different order), and the RANDOM baseline
    rices = {str(q["question_id"]): example_list(train_qs)
             for q in val_qs}
    text_rices = {str(q["question_id"]): example_list(train_qs[::-1])
                  for q in val_qs}
    rnd = np.random.default_rng(1)
    random_examples = {
        str(q["question_id"]): example_list(
            [train_qs[i] for i in rnd.permutation(len(train_qs))]
        )
        for q in val_qs
    }

    def dump(obj, name):
        path = os.path.join(data_dir, name)
        with open(path, "wb") as fh:
            pickle.dump(obj, fh)
        return path

    return {
        "questions_train": files["train_q"],
        "annotations_train": files["train_a"],
        "questions_val": files["val_q"], "annotations_val": files["val_a"],
        "embeddings": files["embeddings"],
        "rices": dump(rices, "rices.pkl"),
        "text_rices": dump(text_rices, "rices_questions_only.pkl"),
        "random": dump(random_examples, "random.pkl"),
    }


def _write_tiny_weights(out_dir: str) -> str:
    """Tiny HF T5 checkpoint dir wearing the committed tokenizer fixture
    (the shape of tests/test_replicate_baseline.py::tiny_weights_dir)."""
    import torch
    import transformers

    if not os.path.isdir(TOK_FIXTURE):
        raise FileNotFoundError(
            f"committed tokenizer fixture not found at {TOK_FIXTURE} — "
            "run the dryrun from a repo checkout"
        )
    hf_cfg = transformers.T5Config(
        vocab_size=256, d_model=D_MODEL, d_kv=8, num_heads=4, d_ff=64,
        num_layers=2, num_decoder_layers=2,
        feed_forward_proj="gated-gelu", tie_word_embeddings=False,
        dropout_rate=0.0, relative_attention_num_buckets=8,
        relative_attention_max_distance=16,
        decoder_start_token_id=0, pad_token_id=0, eos_token_id=1,
    )
    torch.manual_seed(3)
    model = transformers.T5ForConditionalGeneration(hf_cfg)
    model.save_pretrained(out_dir)
    for name in os.listdir(TOK_FIXTURE):
        shutil.copy(os.path.join(TOK_FIXTURE, name),
                    os.path.join(out_dir, name))
    return out_dir


def _write_mapper_ckpt(path: str) -> str:
    """Reference-style PL checkpoint of the MLP mapper
    (reference: src/models/vct0.py:58-69 torch Linear layout)."""
    import torch

    hidden = (D_MODEL * PREFIX_LEN) // 2
    torch.manual_seed(4)
    state_dict = {
        "model.clip_project.model.0.weight":
            torch.randn(hidden, PREFIX_SIZE),
        "model.clip_project.model.0.bias": torch.randn(hidden),
        "model.clip_project.model.2.weight":
            torch.randn(D_MODEL * PREFIX_LEN, hidden),
        "model.clip_project.model.2.bias":
            torch.randn(D_MODEL * PREFIX_LEN),
    }
    torch.save({"state_dict": state_dict}, path)
    return path


def build_dryrun_argv(workdir: str, modes=None, int8: bool = True,
                      shots=None, device=None) -> list:
    """Create all tiny artifacts under workdir and return the full
    replicate_baseline argv for the dress rehearsal."""
    os.makedirs(workdir, exist_ok=True)
    artifacts = _write_vqa_artifacts(os.path.join(workdir, "data"))
    weights = _write_tiny_weights(os.path.join(workdir, "tiny_t0"))
    ckpt = _write_mapper_ckpt(os.path.join(workdir, "model_00.ckpt"))
    argv = [
        "--t0-weights", weights,
        "--mapper-ckpt", ckpt,
        "--questions-train", artifacts["questions_train"],
        "--annotations-train", artifacts["annotations_train"],
        "--questions-val", artifacts["questions_val"],
        "--annotations-val", artifacts["annotations_val"],
        "--clip-embeddings-train", artifacts["embeddings"],
        "--clip-embeddings-val", artifacts["embeddings"],
        "--rices", artifacts["rices"],
        "--text-rices", artifacts["text_rices"],
        "--random-examples", artifacts["random"],
        "--modes", *(modes or ["main", "no_prefix", "text_rices",
                               "ensemble", "random"]),
        "--templates", "hotpotqa", "frozen",
        "--batch-size", "2",
        "--compute-dtype", "float32", "--params-dtype", "float32",
        "--fused-attention", "0",
        "--workdir", os.path.join(workdir, "run"),
        "--output", os.path.join(workdir, "dryrun_report.json"),
    ]
    if shots:
        argv += ["--shots", *[str(s) for s in shots]]
    if device:
        argv += ["--device", str(device)]
    opts = [
        f"model_config.model_args.prefix_size={PREFIX_SIZE}",
        f"model_config.model_args.prefix_length={PREFIX_LEN}",
        "data_loader.additional.max_target_length=8",
    ]
    if int8:
        argv += ["--compare-bf16"]
        opts += ["tpu.int8_encoder_ffn=True", "tpu.int8_cross_kv=True"]
    argv += ["--opts", *opts]
    return argv


def main(argv=None, device=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workdir", default="replicate_dryrun_workdir")
    parser.add_argument("--modes", nargs="+", default=None,
                        help="default: ALL published-table modes")
    parser.add_argument("--shots", type=int, nargs="+", default=None)
    parser.add_argument("--no-int8", action="store_true",
                        help="skip the int8-vs-bf16 twin + drift study")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card")
    parser.add_argument("--poke-missing", action="store_true",
                        help="delete one artifact first to demo the loud "
                        "missing-artifact checklist, expect failure")
    args = parser.parse_args(argv)

    from .replicate_baseline import main as replicate_main

    rb_argv = build_dryrun_argv(args.workdir, modes=args.modes,
                                int8=not args.no_int8, shots=args.shots,
                                device=device or args.device)
    if args.poke_missing:
        rices = rb_argv[rb_argv.index("--rices") + 1]
        os.remove(rices)
        try:
            replicate_main(rb_argv)
        except FileNotFoundError as exc:
            print(f"\nchecklist fired as intended:\n{exc}")
            return 0
        print("ERROR: missing artifact was not detected", file=sys.stderr)
        return 1
    rc = replicate_main(rb_argv)
    report_path = os.path.join(args.workdir, "dryrun_report.json")
    with open(report_path) as fh:
        report = json.load(fh)
    print(f"\ndress rehearsal complete: {len(report['rows'])} sweep "
          f"points, report at {report_path}")
    print("NOTE: tiny random-ish weights — accuracies are NOT expected "
          "to match the published table; this validates the HARNESS "
          "(verdicts are informational).")
    return rc if rc == 0 else 0  # tiny weights legitimately FAIL parity


if __name__ == "__main__":
    raise SystemExit(main())
