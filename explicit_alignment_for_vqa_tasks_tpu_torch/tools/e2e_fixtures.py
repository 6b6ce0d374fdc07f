"""Synthetic end-to-end fixtures: VQA2 and Conceptual Captions artifacts in
the reference's file formats, the tiny test configs that read them, and the
executor built from a config.

The port's copy of the fixture functions of the JAX package's
``tests/test_e2e.py`` (``write_vqa_fixtures``, ``make_test_config``,
``build_executor``, ``TestConceptualCaptionsTraining.make_cc_config``): the
same files, byte for byte, and the same configs, read through the port's
config system, so that the port's tools (``eval_pipeline_bench``,
``hw_smoke``) need no test code and nothing of the JAX package.

``KERNEL_LM_CONFIG`` is the fixtures' two-layer T5 widened to the smallest
shapes the card's kernels take (heads of 32, widths a multiple of 128): the
tests' 8-wide heads are below ``t5_attention_core``'s 16, and the int8
encoder kernels tile widths by 128.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import pickle
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

from .. import data as _data  # noqa: F401 — populates DATA_LOADERS/DATASETS
from .. import trainers as _trainers  # noqa: F401 — populates EXECUTORS
from ..data.data_loader_conceptual_captions import DataLoaderConceptualCaptions
from ..data.loader import ListDataset
from ..device import DeviceLike
from ..registry import DATA_LOADERS, EXECUTORS
from ..utils.attr_dict import AttrDict
from ..utils.config_system import process_config

PREFIX_SIZE = 16
REPO_ROOT = Path(__file__).resolve().parents[2]
# the shipped configs, relative to REPO_ROOT as the CLI is given them
VQA_CONFIG = "configs/vqa2/few_shot_vqa_hotpotqa.jsonnet"
CC_CONFIG = "configs/conceptual_captions/conceptual_captions.jsonnet"
ANSWERS = ("red", "blue", "green")
TEST_LM_CONFIG = {
    "d_model": 32, "d_kv": 8, "num_heads": 4, "d_ff": 64,
    "num_encoder_layers": 2, "num_decoder_layers": 2,
    "relative_attention_num_buckets": 8,
    "relative_attention_max_distance": 16,
}
KERNEL_LM_CONFIG = dict(TEST_LM_CONFIG, d_model=128, d_kv=32, d_ff=256)
CC_ROWS = 12


def _make_split(data_dir: Path, name: str, n_imgs: int,
                qid_base: int) -> Tuple[str, str, List[dict]]:
    questions, annotations = [], []
    for i in range(n_imgs):
        img_id = qid_base // 1000 + i
        qid = qid_base + i
        questions.append({
            "question_id": qid, "image_id": img_id,
            "question": f"what color is object {i} ?",
        })
        answer = ANSWERS[i % 3]
        annotations.append({
            "question_id": qid, "image_id": img_id,
            "question_type": "what color is",
            "answer_type": "other",
            "multiple_choice_answer": answer,
            "answers": [
                {"answer": answer, "answer_confidence": "yes",
                 "answer_id": k + 1} for k in range(10)
            ],
        })
    q_file = data_dir / f"{name}_questions.json"
    a_file = data_dir / f"{name}_annotations.json"
    q_file.write_text(json.dumps({
        "info": {}, "task_type": "Open-Ended", "data_type": "mscoco",
        "data_subtype": name, "license": {}, "questions": questions,
    }))
    a_file.write_text(json.dumps({
        "info": {}, "task_type": "Open-Ended", "data_type": "mscoco",
        "data_subtype": name, "license": {}, "annotations": annotations,
    }))
    return str(q_file), str(a_file), questions


def write_vqa_splits(data_dir: Path, n_train_imgs: int, n_val_imgs: int
                     ) -> Tuple[Dict[str, str], List[dict], List[dict]]:
    """The train2014 and val2014 question and annotation files and the
    CLIP-embedding pickle (keyed by ``str(image_id)``, one (1, PREFIX_SIZE)
    row an image from ``default_rng(0)``) under ``data_dir``; returns their
    paths and the train and val questions."""
    data_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    train_q, train_a, train_qs = _make_split(data_dir, "train2014",
                                             n_train_imgs, 1000000)
    val_q, val_a, val_qs = _make_split(data_dir, "val2014", n_val_imgs,
                                       2000000)
    embeddings = {
        str(q["image_id"]): rng.standard_normal((1, PREFIX_SIZE))
        .astype(np.float32) for q in train_qs + val_qs
    }
    emb_file = data_dir / "clip_embeddings.pkl"
    emb_file.write_bytes(pickle.dumps(embeddings))
    files = dict(train_q=train_q, train_a=train_a, val_q=val_q, val_a=val_a,
                 embeddings=str(emb_file))
    return files, train_qs, val_qs


def example_list(train_qs: List[dict]) -> List[dict]:
    """In-context examples in ``train_qs``' order (best LAST), gold answers
    by position."""
    return [{"question_id": tq["question_id"], "img_key": tq["image_id"],
             "question": tq["question"], "gold_answer": ANSWERS[i % 3]}
            for i, tq in enumerate(train_qs)]


def write_vqa_fixtures(tmp_path: Path, n_train_imgs: int = 6,
                       n_val_imgs: int = 4) -> Dict[str, str]:
    """Synthetic VQA2 artifacts in the reference's file formats under
    ``tmp_path/data``: the splits, the CLIP embeddings and a RICES pickle
    that gives every val question all train questions."""
    data_dir = Path(tmp_path) / "data"
    files, train_qs, val_qs = write_vqa_splits(data_dir, n_train_imgs,
                                               n_val_imgs)
    rices = {str(q["question_id"]): example_list(train_qs) for q in val_qs}
    rices_file = data_dir / "rices.pkl"
    rices_file.write_bytes(pickle.dumps(rices))
    return dict(files, rices=str(rices_file))


def _process_config(config: str, mode: str, experiment_name: str, **kw
                    ) -> AttrDict:
    """``process_config`` of the CLI's arguments, the config file read from
    REPO_ROOT (the working directory is restored after)."""
    args = dict(
        config=config, mode=mode, experiment_name=experiment_name,
        reset=False, num_shots=-1, no_prefix=0,
        pass_examples_through_encoder_one_at_a_time=0,
        num_permutations_of_in_context_examples=0, sample_templates=0,
        ensemble_one_shots=0, in_context_examples_fpath="", modules=[],
        tags=[], test_batch_size=-1, test_evaluation_name="", opts=[])
    args.update(kw)
    with contextlib.chdir(REPO_ROOT):
        return process_config(argparse.Namespace(**args))


def _tiny_lm(config: AttrDict) -> None:
    """The fixtures' model: the two-layer T5 at the tests' widths, random
    weights, prefix 2 x PREFIX_SIZE, fp32, the offline tokenizer."""
    config.model_config.TokenizerClass = "SimpleTokenizer"
    config.model_config.ConfigClass = "T5_test"
    config.model_config.lm_config = dict(TEST_LM_CONFIG)
    config.model_config.pretrained = 0
    config.model_config.model_args.prefix_size = PREFIX_SIZE
    config.model_config.model_args.prefix_length = 2
    config.tpu.compute_dtype = "float32"
    config.tpu.params_dtype = "float32"


def make_test_config(tmp_path: Path, fixtures: Dict[str, str],
                     **extra_additional: Any) -> AttrDict:
    """The shipped few-shot config (2 shots, test batch 2) on the fixtures:
    the tiny model, length buckets 64 / 128 / 256, every path under
    ``tmp_path``; each keyword becomes a ``data_loader.additional`` field."""
    tmp_path = Path(tmp_path)
    config = _process_config(
        VQA_CONFIG, "test", "e2e_test", num_shots=2,
        in_context_examples_fpath=fixtures["rices"], test_batch_size=2)
    exp = tmp_path / "experiments" / "e2e_test"
    config.EXPERIMENT_FOLDER = str(tmp_path / "experiments")
    config.TENSORBOARD_FOLDER = str(tmp_path / "tb")
    config.experiment_path = str(exp)
    config.saved_model_path = str(exp / "train" / "saved_model")
    config.results_path = str(exp / "test" / "test_evaluation")
    config.cache.default_folder = str(tmp_path / "cache")
    _tiny_lm(config)
    config.tpu.length_buckets = [64, 128, 256]
    config.data_loader.additional.max_source_length = 256
    config.data_loader.additional.max_target_length = 8
    config.valid.batch_size = 2
    module_dict = config.data_loader.dataset_modules.module_dict
    module_dict.LoadVQA2Data.config.vqa_data_path = AttrDict(
        question_files={"train": fixtures["train_q"],
                        "val": fixtures["val_q"]},
        annotation_files={"train": fixtures["train_a"],
                          "val": fixtures["val_a"]},
    )
    module_dict.LoadVQA2Data.config.image_data_path = AttrDict(
        train=str(tmp_path), val=str(tmp_path))
    module_dict.LoadClipEmbeddings.config = AttrDict(
        train=fixtures["embeddings"], val=fixtures["embeddings"])
    for key, value in extra_additional.items():
        config.data_loader.additional[key] = value
    return config


def cc_table(n: int = CC_ROWS) -> Dict[str, list]:
    """The Conceptual Captions rows' columns (image_url and caption as
    one-element lists, as the reference stores them), from
    ``default_rng(1)``."""
    rng = np.random.default_rng(1)
    return {
        "image_url": [[f"http://img/{i}"] for i in range(n)],
        "caption": [[f"a photo of object {i} ."] for i in range(n)],
        "clip_embeddings": [
            rng.standard_normal(PREFIX_SIZE).astype(np.float32).tolist()
            for _ in range(n)
        ],
    }


class PickledConceptualCaptions(DataLoaderConceptualCaptions):
    """The shipped Conceptual Captions loader over rows pickled as a list
    of dicts, where pyarrow, which the parquet files need, is absent
    (registered by ``write_cc_rows`` only then)."""

    def LoadConceptualCaptions(self, module_config: Any) -> None:
        cfg = module_config.config
        self.data.conceptual_captions = AttrDict({
            split: ListDataset(pickle.loads(Path(cfg[split]).read_bytes()))
            for split in ("train", "val")})


def write_cc_rows(tmp_path: Path) -> Tuple[str, str]:
    """``cc_train`` and ``cc_val`` (the same rows) under ``tmp_path``: the
    parquet artifacts where pyarrow imports, else pickles for
    ``PickledConceptualCaptions``. Returns the loader type and the files'
    suffix."""
    table = cc_table()
    if importlib.util.find_spec("pyarrow") is not None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        for split in ("train", "val"):
            pq.write_table(pa.table(table), tmp_path / f"cc_{split}.parquet")
        return DataLoaderConceptualCaptions.__name__, "parquet"
    DATA_LOADERS.register()(PickledConceptualCaptions)
    rows = [dict(zip(table, values)) for values in zip(*table.values())]
    for split in ("train", "val"):
        (tmp_path / f"cc_{split}.pkl").write_bytes(pickle.dumps(rows))
    return PickledConceptualCaptions.__name__, "pkl"


def make_cc_config(tmp_path: Path) -> AttrDict:
    """The shipped Conceptual Captions training config on CC_ROWS synthetic
    rows (written under ``tmp_path``): the tiny model, 2 epochs of batch
    4, no periodic validation, no gradient accumulation."""
    tmp_path = Path(tmp_path)
    loader_type, suffix = write_cc_rows(tmp_path)
    config = _process_config(CC_CONFIG, "train", "cc_e2e")
    config.EXPERIMENT_FOLDER = str(tmp_path / "experiments")
    config.saved_model_path = str(
        tmp_path / "experiments" / "cc_e2e" / "train" / "saved_model")
    config.cache.default_folder = str(tmp_path / "cache")
    _tiny_lm(config)
    config.train.epochs = 2
    config.train.batch_size = 4
    config.valid.batch_size = 4
    config.valid.step_size = 0
    config.train.additional.gradient_accumulation_steps = 1
    config.data_loader.type = loader_type
    cc = config.data_loader.dataset_modules.module_dict
    cc.LoadConceptualCaptions.config = AttrDict(
        train=str(tmp_path / f"cc_train.{suffix}"),
        val=str(tmp_path / f"cc_val.{suffix}"))
    return config


def on_kernel_widths(config: AttrDict) -> AttrDict:
    """``config`` in bf16 with the fixtures' T5 at KERNEL_LM_CONFIG, the
    widths the card's kernels take."""
    config.model_config.lm_config = dict(KERNEL_LM_CONFIG)
    config.tpu.compute_dtype = "bfloat16"
    config.tpu.params_dtype = "bfloat16"
    return config


def build_executor(config: AttrDict, device: DeviceLike = None) -> Any:
    """The config's data loader, its datasets and loaders, and its executor
    with the model on ``device`` (the card by default)."""
    data_loader = DATA_LOADERS.get(config.data_loader.type)(config)
    data_loader.build_dataset()
    data_loader.set_dataloader()
    return EXECUTORS.get(config.train.type)(config, data_loader,
                                            device=device)
