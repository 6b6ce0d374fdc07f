"""VQA2 dataset-module loaders + dataloader assembly
(reference: src/data_loader_manager/data_loader_vqa2.py:45-569).

Artifact formats are kept pickle/JSON/TSV-compatible with the reference so
existing pre-extracted features drop in unchanged:
  * CLIP embeddings: ``{str(img_key): float32 [1, d]}`` pickles per split
  * in-context examples: ``{str(question_id): [ {question_id, img_key,
    question, gold_answer}, ... ]}`` pickle (ascending similarity order)
  * VinVL detections: TSV of (image_key, json prediction)
  * OCR: per-image ``{image_key}_ocr.json`` with filtered_text_annotations

The port's own copy of explicit_alignment_for_vqa_tasks_tpu/data/data_loader_vqa2.py,
held against it by tests/test_torch_eval_data.py and (the VinVL, OCR,
Oscar caption and OK-VQA modules) tests/test_torch_okvqa.py. Where the JAX
package asks ``jax.process_count()`` / ``jax.process_index()``, the port
asks the active mesh for its data coordinate (``parallel.mesh.data_shard``:
the rank among the processes where there is no mesh): an eval over several
processes gives each data shard its questions, the ranks of one model
group the same ones; a training run (ClipCap's) gives each data shard its
rows of the training set too.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import pickle
from typing import Any, Dict, List

import numpy as np

from ..device import world_size
from ..parallel.mesh import data_shard
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

    def LoadVinVLFeatures(self, module_config: Any) -> None:
        """VinVL object/attribute detections from TSV, cached
        (reference: data_loader_vqa2.py:119-173)."""
        csv.field_size_limit(100_000_000)
        self.data.vinvl_features = load_cached_data(
            self.config, "vinvl_feature_preprocessed"
        )
        if not self.data.vinvl_features:
            features: Dict[str, Any] = {}
            for split in ("train", "test"):
                path = module_config.config[split]
                logger.info("reading VinVL features: %s", path)
                with open(path, "r", encoding="utf-8") as fh:
                    for row in csv.reader(fh, delimiter="\t"):
                        image_key, prediction = row
                        features[image_key] = json.loads(prediction)
            self.data.vinvl_features = features
            save_cached_data(
                self.config, features, "vinvl_feature_preprocessed"
            )
        logger.info(
            "[Data Statistics] VinVL features %d",
            len(self.data.vinvl_features),
        )

    def LoadGoogleOCRFeatures(self, module_config: Any) -> None:
        """Per-image OCR JSON; optionally matches OCR text to VinVL boxes
        by polygon containment + area ratio
        (reference: data_loader_vqa2.py:175-296)."""
        self.data.ocr_features = load_cached_data(
            self.config, "ocr_feature_preprocessed"
        )
        if not self.data.ocr_features:
            ocr: Dict[str, Any] = {}
            for split in ("train", "test"):
                folder = module_config.config[split]
                logger.info("reading OCR features from %s", folder)
                for image_key in self.data.vinvl_features:
                    path = os.path.join(folder, f"{image_key}_ocr.json")
                    if os.path.exists(path):
                        with open(path, "r", encoding="utf-8") as fh:
                            ocr[image_key] = json.load(fh)
            self.data.ocr_features = ocr
            save_cached_data(self.config, ocr, "ocr_feature_preprocessed")

        annotated = sum(
            1 for a in self.data.ocr_features.values()
            if a.get("filtered_text_annotations")
        )
        logger.info(
            "[Data Statistics] OCR features %d, %d with annotations",
            len(self.data.ocr_features), annotated,
        )
        if module_config.config.get("combine_with_vinvl"):
            self._combine_ocr_with_vinvl()

    def _combine_ocr_with_vinvl(self) -> None:
        """Each OCR polygon inside a VinVL box is attached to that box as
        {"text", "score": polygon area / box area}; each image gets its
        count of matches as "ocr". In float64 numpy, as in JAX."""
        def poly_area(xs, ys) -> float:
            xs, ys = np.asarray(xs, dtype=np.float64), np.asarray(ys, np.float64)
            return 0.5 * abs(
                np.dot(xs, np.roll(ys, 1)) - np.dot(ys, np.roll(xs, 1))
            )

        first = next(iter(self.data.vinvl_features.values()), None)
        if first is None or "ocr" in first:
            logger.info("OCR already merged into VinVL features; skipping")
            return
        for image_key, prediction in self.data.vinvl_features.items():
            annotations = self.data.ocr_features.get(image_key, {}).get(
                "filtered_text_annotations", []
            )
            count = 0
            for annotation in annotations:
                description = annotation["description"].replace("\n", " ")
                vertices = np.asarray(annotation["vertices"], dtype=np.float64)
                area = poly_area(vertices[:, 0], vertices[:, 1])
                for obj in prediction["objects"]:
                    xmin, ymin, xmax, ymax = obj["rect"]
                    obj_area = (ymax - ymin) * (xmax - xmin)
                    inside = (
                        np.all(vertices[:, 0] >= xmin)
                        and np.all(vertices[:, 0] <= xmax)
                        and np.all(vertices[:, 1] >= ymin)
                        and np.all(vertices[:, 1] <= ymax)
                    )
                    score = area / obj_area if inside and obj_area > 0 else 0.0
                    if score > 0:
                        count += 1
                        obj.setdefault("ocr", []).append(
                            {"text": description, "score": score}
                        )
            prediction["ocr"] = count
        save_cached_data(
            self.config, self.data.vinvl_features, "vinvl_feature_preprocessed"
        )

    def LoadOscarCaptionFeatures(self, module_config: Any) -> None:
        """Predicted captions keyed by image id
        (reference: data_loader_vqa2.py:298-322)."""
        self.data.caption_features = {}
        for path in module_config.config.values():
            with open(path, "r", encoding="utf-8") as fh:
                self.data.caption_features.update(json.load(fh))
        logger.info(
            "[Data Statistics] caption features %d",
            len(self.data.caption_features),
        )

    def LoadVQA2Data(self, module_config: Any) -> None:
        """Build per-question data items from the official VQA files with
        gold_answer = most frequent of the 10 answers, pickle-cached per
        split (reference: data_loader_vqa2.py:324-496)."""
        self._load_vqa_format_data(module_config, target="vqa2_data")

    def LoadOKVQAData(self, module_config: Any) -> None:
        """OK-VQA: its files use the official VQA format, so loading is
        shared; the result lands in data.okvqa_data for
        compute_okvqa_scores (the reference scored okvqa_data without
        shipping a loader; the JAX package added this one)."""
        self._load_vqa_format_data(module_config, target="okvqa_data")

    def _load_vqa_format_data(self, module_config: Any, target: str) -> None:
        """The splits' data items into data[target] (and data.vqa_data),
        cached as ``{split}_data_preprocessed`` for VQA2 (the reference's
        names) and ``{target}_{split}_data_preprocessed`` otherwise."""
        answer_candidates: List[str] = []
        splits = ["val"] if self.config.mode == "test" else ["train", "val"]
        vqa_helpers = {
            split: VQA(
                module_config.config.vqa_data_path.annotation_files[split],
                module_config.config.vqa_data_path.question_files[split],
            )
            for split in splits
        }

        vqa_data = self.data[target] = AttrDict(
            train={}, val={}, lookup={}, vqa_helpers=vqa_helpers
        )
        cache_prefix = "" if target == "vqa2_data" else f"{target}_"

        for split, helper in vqa_helpers.items():
            cache_name = f"{cache_prefix}{split}_data_preprocessed"
            cached = load_cached_data(self.config, cache_name)
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
                save_cached_data(self.config, vqa_data[split], cache_name)

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
            vinvl_features=self.data.get("vinvl_features"),
            ocr_features=self.data.get("ocr_features"),
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
        processes = world_size()
        data_id, data_ways = data_shard()
        num_workers = additional.get("num_workers", 8)
        num_workers_test = additional.get("num_workers_test", 4)
        if isinstance(self.tokenizer, SimpleTokenizer) or isinstance(
                self.decoder_tokenizer, SimpleTokenizer):
            num_workers = num_workers_test = 1
        if self.config.mode == "train":
            self.train_dataset = dataset_cls(self.config, dict(
                common, data=self.data.vqa_data.train, mode="train"))
            # data-parallel training: each data shard its [i::D] rows (the
            # same shuffle everywhere), the model group's ranks the same;
            # (0, 1) in one process
            self.train_dataloader = BatchIterator(
                self.train_dataset,
                batch_size=self.config.train.batch_size,
                collate_fn=self.train_dataset.collate_fn,
                shuffle=True,
                seed=self.config.seed,
                num_workers=num_workers,
                shard_id=data_id,
                num_shards=data_ways,
            )
            logger.info("[Data Statistics] train batches: %d",
                        len(self.train_dataloader))
        self.test_dataset = dataset_cls(self.config, dict(
            common, data=self.data.vqa_data.val, mode="test"))
        # multi-process eval: each data shard evaluates its [i::D]
        # questions; predictions are re-united by gather_predictions_to_host0
        # before the VQA protocol's full-coverage check
        shard_id, num_shards = 0, 1
        if processes > 1 and additional.get("shard_eval_by_process", 1):
            shard_id, num_shards = data_id, data_ways
            logger.info("sharding eval data by process: shard %d/%d",
                        shard_id, num_shards)
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

