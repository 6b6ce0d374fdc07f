"""VQA2 dataset-module loaders + dataloader assembly
(reference: src/data_loader_manager/data_loader_vqa2.py:45-569).

Artifact formats are kept pickle/JSON/TSV-compatible with the reference so
existing pre-extracted features drop in unchanged:
  * CLIP embeddings: ``{str(img_key): float32 [1, d]}`` pickles per split
  * in-context examples: ``{str(question_id): [ {question_id, img_key,
    question, gold_answer}, ... ]}`` pickle (ascending similarity order)

The port's own copy of explicit_alignment_for_vqa_tasks_tpu/data/data_loader_vqa2.py,
held against it by tests/test_torch_eval_data.py. Where the JAX package
asks ``jax.process_count()``, the port asks ``torch.distributed``
(``device.world_size``), which refuses a run over more than one process
until the multi-process eval is ported (ROADMAP.md, Queue 1 item 14).
The modules that no shipped config's ``module_list`` names (VinVL, OCR,
Oscar captions, OK-VQA) raise naming Queue 1 item 16.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Any, Dict, List

import numpy as np

from ..device import world_size
from ..registry import DATA_LOADERS, DATASETS
from ..utils.attr_dict import AttrDict
from ..utils.cache_system import load_cached_data, save_cached_data
from ..utils.vqa_tools import VQA
from .data_loader_wrapper import DataLoaderWrapper
from .loader import BatchIterator
from .tokenization import SimpleTokenizer
from . import vqa2_datasets  # noqa: F401 — registers VQA2Dataset

logger = logging.getLogger(__name__)


def _most_frequent(values: List[str]) -> str:
    return max(set(values), key=values.count)


@DATA_LOADERS.register()
class DataLoaderVQA2(DataLoaderWrapper):
    """Few-shot VQA2 data loader."""

    def LoadClipEmbeddings(self, module_config: Any) -> None:
        """Per-image CLIP embedding pickles for train+val, cached
        (reference: data_loader_vqa2.py:53-89)."""
        self.data.clip_embeddings = load_cached_data(
            self.config, "clip_embeddings"
        )
        if not self.data.clip_embeddings:
            merged: Dict[str, np.ndarray] = {}
            for split in ("train", "val"):
                path = module_config.config[split]
                logger.info("reading CLIP embeddings: %s", path)
                with open(path, "rb") as fh:
                    merged.update(pickle.load(fh))
            self.data.clip_embeddings = merged
            save_cached_data(self.config, merged, "clip_embeddings")
        logger.info(
            "[Data Statistics] CLIP embeddings %d",
            len(self.data.clip_embeddings),
        )

    def LoadInContextExamples(self, module_config: Any) -> None:
        """RICES / RANDOM retrieved examples keyed by val question id
        (reference: data_loader_vqa2.py:91-116)."""
        path = module_config.config["file_path"]
        logger.info("reading in-context examples: %s", path)
        with open(path, "rb") as fh:
            self.data.in_context_examples = pickle.load(fh)
        logger.info(
            "[Data Statistics] in-context examples %d",
            len(self.data.in_context_examples),
        )

    def LoadVQA2Data(self, module_config: Any) -> None:
        """Build per-question data items from the official VQA files with
        gold_answer = most frequent of the 10 answers, pickle-cached per
        split (reference: data_loader_vqa2.py:324-496)."""
        answer_candidates: List[str] = []
        splits = ["val"] if self.config.mode == "test" else ["train", "val"]
        vqa_helpers = {
            split: VQA(
                module_config.config.vqa_data_path.annotation_files[split],
                module_config.config.vqa_data_path.question_files[split],
            )
            for split in splits
        }

        vqa_data = self.data.vqa2_data = AttrDict(
            train={}, val={}, lookup={}, vqa_helpers=vqa_helpers
        )

        for split, helper in vqa_helpers.items():
            cached = load_cached_data(
                self.config, f"{split}_data_preprocessed"
            )
            if cached:
                vqa_data[split] = cached
            else:
                img_dir = module_config.config.image_data_path[split]
                img_list = []
                for img_id in helper.img_to_qa:
                    filename = (
                        f"COCO_{helper.data_subtype}_{str(img_id).zfill(12)}.jpg"
                    )
                    img_list.append((img_id, os.path.join(img_dir, filename)))
                    if (
                        self.config.data_loader.dummy_dataloader
                        and len(img_list) > 20
                    ):
                        break

                data_items = []
                for img_id, img_path in img_list:
                    qa_entries = helper.return_qa(
                        helper.load_qa(helper.get_ques_ids(img_ids=[img_id]))
                    )
                    for entry in qa_entries:
                        answers = [
                            a for a in entry["answers"].values() if a != ""
                        ]
                        data_items.append(
                            AttrDict(
                                answers=answers,
                                gold_answer=_most_frequent(answers),
                                question=entry["question"],
                                question_id=entry["question_id"],
                                img_path=img_path,
                                img_key_full=str(img_id).zfill(12),
                                img_key=img_id,
                                img=[],
                            )
                        )
                        for ans in entry["answers"].values():
                            if ans not in answer_candidates:
                                answer_candidates.append(ans)

                vqa_data[split] = AttrDict(data_items=data_items)
                save_cached_data(
                    self.config,
                    vqa_data[split],
                    f"{split}_data_preprocessed",
                )

            for item in vqa_data[split].data_items:
                vqa_data.lookup[str(item.question_id)] = item
            logger.info(
                "[Data statistics] split %s: %d entries",
                split, len(vqa_data[split].data_items),
            )

        vqa_data.answer_candidate_list = answer_candidates
        self.data.vqa_data = vqa_data

    def set_dataloader(self) -> None:
        """Wrap the val split in the test batch iterator, and in train mode
        the train split in the shuffled train iterator
        (reference: data_loader_vqa2.py:498-569)."""
        dataset_cls = DATASETS.get(self.config.data_loader.dataset_type)
        common = dict(
            clip_embeddings=self.data.get("clip_embeddings"),
            in_context_examples=self.data.get("in_context_examples"),
            answer_candidate_list=self.data.vqa_data.answer_candidate_list,
            tokenizer=self.tokenizer,
            decoder_tokenizer=self.decoder_tokenizer,
            feature_extractor=self.feature_extractor,
            image_preprocessor=self.image_preprocessor,
        )
        additional = self.config.data_loader.additional
        # reference loaders: 8 train and 4 test workers
        # (data_loader_vqa2.py:529, :563). SimpleTokenizer numbers words in
        # the order it first meets them: one collate thread keeps that
        # order, and so the ids, the same from run to run
        num_workers = additional.get("num_workers", 8)
        num_workers_test = additional.get("num_workers_test", 4)
        if isinstance(self.tokenizer, SimpleTokenizer) or isinstance(
                self.decoder_tokenizer, SimpleTokenizer):
            num_workers = num_workers_test = 1
        if self.config.mode == "train":
            self.train_dataset = dataset_cls(self.config, dict(
                common, data=self.data.vqa_data.train, mode="train"))
            self.train_dataloader = BatchIterator(
                self.train_dataset,
                batch_size=self.config.train.batch_size,
                collate_fn=self.train_dataset.collate_fn,
                shuffle=True,
                seed=self.config.seed,
                num_workers=num_workers,
            )
            logger.info("[Data Statistics] train batches: %d",
                        len(self.train_dataloader))
        self.test_dataset = dataset_cls(self.config, dict(
            common, data=self.data.vqa_data.val, mode="test"))
        # one process: its shard [0::1] is the whole question set (the
        # JAX package shards by process here, world_size refuses that)
        shard_id, num_shards = 0, world_size()
        self.test_dataloader = BatchIterator(
            self.test_dataset,
            batch_size=self.config.valid.batch_size,
            collate_fn=self.test_dataset.collate_fn,
            shuffle=False,
            num_workers=num_workers_test,
            shard_id=shard_id,
            num_shards=num_shards,
        )
        logger.info(
            "[Data Statistics] test batches: %d", len(self.test_dataloader)
        )


def _not_ported(name: str):
    def load(self, module_config: Any) -> None:
        raise NotImplementedError(
            f"the dataset module {name} is not ported yet (ROADMAP.md, "
            "Queue 1 item 16)")
    load.__name__ = name
    return load


for _name in ("LoadVinVLFeatures", "LoadGoogleOCRFeatures",
              "LoadOscarCaptionFeatures", "LoadOKVQAData"):
    setattr(DataLoaderVQA2, _name, _not_ported(_name))
