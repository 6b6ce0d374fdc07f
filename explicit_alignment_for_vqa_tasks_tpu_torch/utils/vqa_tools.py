"""VQA annotation/result helper (the official VQA API surface).

A clean re-implementation of the dataset-access layer used by the official
VQA evaluation protocol (reference: src/utils/vqa_tools.py:24-242, itself
derived from GT-Vision-Lab/VQA). Provides annotation indexing, question/image
id filtering, and result loading with the full-coverage assertion that acts
as an integration check on every eval run (reference: vqa_tools.py:224-229).

The port's own copy of explicit_alignment_for_vqa_tasks_tpu/utils/vqa_tools.py,
held against it by tests/test_torch_vqa_scoring.py.
"""

from __future__ import annotations

import copy
import json
import logging
from typing import Any, Dict, List, Optional, Sequence, Union

logger = logging.getLogger(__name__)

_COPY_FIELDS = ("info", "task_type", "data_type", "data_subtype", "license")


def _as_list(x: Union[Any, Sequence[Any]]) -> List[Any]:
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class VQA:
    """Loads VQA v2 annotation + question files and indexes them."""

    def __init__(
        self,
        annotation_file: Optional[str] = None,
        question_file: Optional[str] = None,
    ):
        self.annotation_file = annotation_file
        self.question_file = question_file
        self.dataset: Dict[str, Any] = {}
        self.questions: Dict[str, Any] = {}
        self.qa: Dict[int, Dict] = {}
        self.qqa: Dict[int, Dict] = {}
        self.img_to_qa: Dict[int, List[Dict]] = {}
        if annotation_file is not None and question_file is not None:
            logger.info("loading VQA annotations from %s", annotation_file)
            with open(annotation_file, "r", encoding="utf-8") as fh:
                self.dataset = json.load(fh)
            with open(question_file, "r", encoding="utf-8") as fh:
                self.questions = json.load(fh)
            self.create_index()

    # camelCase aliases keep the official API surface available
    @property
    def imgToQA(self) -> Dict[int, List[Dict]]:
        return self.img_to_qa

    def create_index(self) -> None:
        self.qa = {}
        self.qqa = {}
        self.img_to_qa = {}
        for ann in self.dataset.get("annotations", []):
            self.qa[ann["question_id"]] = ann
            self.img_to_qa.setdefault(ann["image_id"], []).append(ann)
        for ques in self.questions.get("questions", []):
            self.qqa[ques["question_id"]] = ques

    createIndex = create_index

    def get_ques_ids(
        self,
        img_ids: Sequence[int] = (),
        ques_types: Sequence[str] = (),
        ans_types: Sequence[str] = (),
    ) -> List[int]:
        """Question ids matching all given filters (empty filter = no-op)."""
        img_ids, ques_types, ans_types = (
            _as_list(img_ids), _as_list(ques_types), _as_list(ans_types)
        )
        if img_ids:
            anns: List[Dict] = []
            for img_id in img_ids:
                anns.extend(self.img_to_qa.get(img_id, []))
        else:
            anns = list(self.dataset.get("annotations", []))
        if ques_types:
            anns = [a for a in anns if a["question_type"] in ques_types]
        if ans_types:
            anns = [a for a in anns if a["answer_type"] in ans_types]
        return [a["question_id"] for a in anns]

    def getQuesIds(self, imgIds=(), quesTypes=(), ansTypes=()) -> List[int]:
        return self.get_ques_ids(imgIds, quesTypes, ansTypes)

    def get_img_ids(
        self,
        ques_ids: Sequence[int] = (),
        ques_types: Sequence[str] = (),
        ans_types: Sequence[str] = (),
    ) -> List[int]:
        ques_ids, ques_types, ans_types = (
            _as_list(ques_ids), _as_list(ques_types), _as_list(ans_types)
        )
        if ques_ids:
            anns = [self.qa[qid] for qid in ques_ids if qid in self.qa]
        else:
            anns = list(self.dataset.get("annotations", []))
        if ques_types:
            anns = [a for a in anns if a["question_type"] in ques_types]
        if ans_types:
            anns = [a for a in anns if a["answer_type"] in ans_types]
        return [a["image_id"] for a in anns]

    def getImgIds(self, quesIds=(), quesTypes=(), ansTypes=()) -> List[int]:
        return self.get_img_ids(quesIds, quesTypes, ansTypes)

    def load_qa(self, ids: Union[int, Sequence[int]] = ()) -> List[Dict]:
        if isinstance(ids, int):
            return [self.qa[ids]]
        return [self.qa[qid] for qid in ids]

    loadQA = load_qa

    @property
    def data_subtype(self) -> Optional[str]:
        return self.dataset.get("data_subtype")

    # official-API alias
    dataSubType = data_subtype

    def return_qa(self, anns: Sequence[Dict]) -> List[Dict]:
        """Flatten annotations to {image_id, question_id, question, answers}
        with answers keyed by answer_id (reference: vqa_tools.py:152-172)."""
        out = []
        for ann in anns:
            qid = ann["question_id"]
            out.append(
                {
                    "image_id": ann["image_id"],
                    "question_id": qid,
                    "question": self.qqa[qid]["question"],
                    "answers": {
                        a["answer_id"]: a["answer"] for a in ann["answers"]
                    },
                }
            )
        return out

    returnQA = return_qa

    def _make_res_skeleton(self) -> "VQA":
        res = VQA()
        if self.question_file is not None:
            with open(self.question_file, "r", encoding="utf-8") as fh:
                res.questions = json.load(fh)
        else:
            res.questions = copy.deepcopy(self.questions)
        for field in _COPY_FIELDS:
            if field in self.questions:
                res.dataset[field] = copy.deepcopy(self.questions[field])
        return res

    def load_res_from_list(self, predictions: List[Dict]) -> "VQA":
        """Build a result object from in-memory predictions
        ``[{"question_id": int, "answer": str}, ...]``.

        Asserts predictions cover exactly the annotation question-id set —
        the official protocol's integration check
        (reference: vqa_tools.py:228-229).
        """
        res = self._make_res_skeleton()
        assert isinstance(predictions, list), "results must be a list of dicts"
        pred_ids = {p["question_id"] for p in predictions}
        ann_ids = set(self.get_ques_ids())
        assert pred_ids == ann_ids, (
            "Results do not correspond to the current VQA set: predictions "
            "must cover every annotated question id and nothing else "
            f"(missing={len(ann_ids - pred_ids)}, "
            f"extra={len(pred_ids - ann_ids)})"
        )
        anns = []
        for pred in predictions:
            ann = dict(pred)
            qid = ann["question_id"]
            src = self.qa[qid]
            if res.dataset.get("task_type") == "Multiple Choice":
                choices = self.qqa[qid]["multiple_choices"]
                assert ann["answer"] in choices, (
                    "predicted answer is not one of the multiple choices"
                )
            ann["image_id"] = src["image_id"]
            ann["question_type"] = src["question_type"]
            ann["answer_type"] = src["answer_type"]
            anns.append(ann)
        res.dataset["annotations"] = anns
        res.create_index()
        return res

    loadResFromDict = load_res_from_list

    def load_res(self, res_file: str, ques_file: Optional[str] = None) -> "VQA":
        with open(res_file, "r", encoding="utf-8") as fh:
            predictions = json.load(fh)
        return self.load_res_from_list(predictions)

    def loadRes(self, resFile: str, quesFile: Optional[str] = None) -> "VQA":
        return self.load_res(resFile, quesFile)
