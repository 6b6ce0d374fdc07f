"""Config-driven metric computation.

Mirrors the reference MetricsProcessor
(reference: src/trainers/metrics_processors.py:24-495): executors mix this
in; ``compute_metrics`` dispatches over the config ``metrics`` list by
function name. VQA scores run the official protocol (utils/vqa_eval.py);
failures during sanity checks are tolerated
(reference: metrics_processors.py:435-444).

The port's own copy of
explicit_alignment_for_vqa_tasks_tpu/trainers/metrics_processors.py, held
against it by tests/test_torch_vqa_scoring.py and
tests/test_torch_eval_e2e.py. As in the JAX package, a failure inside the
VQA scoring is logged and not raised (``_vqa_scores``), so callers check
that ``accuracy_overall`` is among the metrics.
"""

from __future__ import annotations

import logging
import os
import pickle
import re
import string
from typing import Any, Dict, List

import numpy as np

from ..device import rank
from ..utils.attr_dict import AttrDict
from ..utils.vqa_eval import VQAEval

logger = logging.getLogger(__name__)


class TextCleaner:
    """Minimal answer normalizer for exact-match metrics (the reference
    imported a missing ``utils.text_cleaner`` module — SURVEY §2.3; this is
    a working equivalent: lowercase, strip articles & punctuation)."""

    _ARTICLES = re.compile(r"\b(a|an|the)\b")

    def clean_texts(self, texts: List[str]) -> List[str]:
        out = []
        for text in texts:
            text = text.lower()
            text = text.translate(str.maketrans("", "", string.punctuation))
            text = self._ARTICLES.sub(" ", text)
            out.append(" ".join(text.split()))
        return out


class MetricsProcessor:
    """Mixin; host class provides self.config, self.data_loader and
    optionally self.in_sanity_check."""

    def compute_metrics(self, data_dict: Dict[str, Any]) -> AttrDict:
        """Run every metric named in config.metrics
        (reference: metrics_processors.py:35-51)."""
        log_dict = AttrDict(metrics={}, artifacts={})
        for metric in self.config.get("metrics", []):
            fn = getattr(self, metric["name"], None)
            if fn is None:
                raise ValueError(f"unknown metric function: {metric['name']}")
            log_dict = fn(metric, data_dict, log_dict)
        return log_dict

    # ------------------------------------------------------------------

    def _vqa_scores(self, vqa_helpers, data_dict, log_dict, label: str):
        try:
            mode = data_dict["mode"]
            if mode == "test":
                mode = "val"  # test evaluates on the val split
            answers = data_dict["batch_predictions"]
            vqa_helper = vqa_helpers[mode]
            vqa_res = vqa_helper.load_res_from_list(list(answers))
            evaluator = VQAEval(vqa_helper, vqa_res, n=2)
            evaluator.evaluate()
            logger.info(
                "%s overall accuracy: %.2f", label,
                evaluator.accuracy["overall"],
            )
            metrics = {"accuracy_overall": evaluator.accuracy["overall"]}
            for q_type, value in evaluator.accuracy["perQuestionType"].items():
                metrics[f"accuracy_QuestionType_{q_type}"] = value
            for a_type, value in evaluator.accuracy["perAnswerType"].items():
                metrics[f"accuracy_AnswerType_{a_type}"] = value
            log_dict.metrics.update(metrics)
        except Exception as exc:
            # predictions may not cover the full question set during
            # sanity checks / dummy runs (reference behavior,
            # metrics_processors.py:435-444)
            if getattr(self, "in_sanity_check", False):
                logger.info("%s scoring skipped during sanity check: %s",
                            label, exc)
            else:
                logger.error("failed to compute %s scores: %s", label, exc)
        return log_dict

    def compute_vqa_scores(self, module, data_dict, log_dict) -> AttrDict:
        """Official VQA accuracy incl. per-type breakdowns
        (reference: metrics_processors.py:373-444)."""
        return self._vqa_scores(
            self.data_loader.data.vqa_data.vqa_helpers, data_dict, log_dict,
            "VQA",
        )

    def compute_okvqa_scores(self, module, data_dict, log_dict) -> AttrDict:
        """OK-VQA variant (reference: metrics_processors.py:303-371) over
        the split LoadOKVQAData loaded."""
        return self._vqa_scores(
            self.data_loader.data.okvqa_data.vqa_helpers, data_dict, log_dict,
            "OKVQA",
        )

    def compute_accuracy(self, module, data_dict, log_dict) -> AttrDict:
        """Exact membership of the prediction in the answer list
        (reference: metrics_processors.py:56-78)."""
        correct = []
        lookup = self.data_loader.data.vqa_data.lookup
        for prediction in data_dict["batch_predictions"]:
            annotation = lookup.get(str(prediction["question_id"]))
            if annotation is None:
                raise ValueError(
                    "annotation not found for question_id "
                    f"{prediction['question_id']}"
                )
            correct.append(
                1 if prediction["answer"] in annotation["answers"] else 0
            )
        log_dict.metrics["accuracy"] = float(np.mean(correct)) if correct \
            else 0.0
        return log_dict

    def compute_exact_match(self, module, data_dict, log_dict) -> AttrDict:
        """Exact match at k over loss-ranked answer proposals
        (reference: metrics_processors.py:80-135)."""
        cleaner = TextCleaner()
        n_beams = 5
        results = {f"exact_match_at_{b + 1}": [] for b in range(n_beams)}
        for answer_list, proposals, losses in zip(
            data_dict["batch_answers"],
            data_dict["batch_generation_outputs_for_docs"],
            data_dict["batch_loss_with_doc_scores"],
        ):
            answer_list = cleaner.clean_texts(list(answer_list))
            proposals = cleaner.clean_texts(list(proposals))
            ranked: List[str] = []
            for idx in np.argsort(losses):
                if proposals[idx] not in ranked:
                    ranked.append(proposals[idx])
            hit = 0
            for b in range(n_beams):
                if b < len(ranked) and ranked[b] in answer_list:
                    hit = 1
                results[f"exact_match_at_{b + 1}"].append(hit)
        log_dict.metrics.update(
            {k: float(np.mean(v)) if v else 0.0 for k, v in results.items()}
        )
        return log_dict

    def compute_retrieval_metrics(self, module, data_dict, log_dict) -> AttrDict:
        """Retrieval quality metrics for retrieval-augmented variants
        (reference: metrics_processors.py:137-301): recall/precision of
        answers appearing in retrieved docs, plus retriever-hit breakdowns
        over loss-ranked per-doc generations."""
        batch_answers = data_dict["batch_answers"]
        batch_docs = data_dict["batch_retrieved_docs"]
        batch_proposals = data_dict["batch_generation_outputs_for_docs"]
        batch_losses = data_dict["batch_loss_with_doc_scores"]

        result = {"recall": [], "precision": [], "gold_precision": [],
                  "gold_recall": []}
        for answer_list, docs in zip(batch_answers, batch_docs):
            filtered = [a for a in answer_list if a != ""]
            gold = max(set(filtered), key=filtered.count)
            unique_answers = list(set(answer_list))
            doc_texts = [doc["content"] for doc in docs]
            if "add_null_document" in self.config.model_config.get(
                "modules", []
            ):
                doc_texts = doc_texts[1:]
            found, found_gold = 0, 0
            for passage in doc_texts:
                lower = passage.lower()
                if any(a.lower() in lower for a in unique_answers):
                    found += 1
                if gold.lower() in lower:
                    found_gold += 1
            k = max(len(doc_texts), 1)
            result["recall"].append(1 if found else 0)
            result["precision"].append(found / k)
            result["gold_recall"].append(1 if found_gold else 0)
            result["gold_precision"].append(found_gold / k)

        cleaner = TextCleaner()
        hits = {name: [] for name in (
            "successful_hit", "successful_no_hit", "failed_hit",
            "failed_no_hit", "selected_successful_hit",
            "selected_successful_no_hit", "selected_failed_hit",
            "selected_failed_no_hit",
        )}
        for answer_list, docs, proposals, losses in zip(
            batch_answers, batch_docs, batch_proposals, batch_losses
        ):
            doc_texts = [doc["content"] for doc in docs]
            order = np.argsort(losses)
            answer_list = cleaner.clean_texts(list(answer_list))
            proposals = cleaner.clean_texts(list(proposals))
            picked = int(order[0])
            for index, doc_text in enumerate(doc_texts):
                proposal = proposals[index]
                exact = proposal in answer_list
                contained = proposal in doc_text
                hits["successful_hit"].append(int(exact and contained))
                hits["successful_no_hit"].append(int(exact and not contained))
                hits["failed_hit"].append(int(not exact and contained))
                hits["failed_no_hit"].append(
                    int(not exact and not contained)
                )
                if index == picked:
                    hits["selected_successful_hit"].append(
                        int(exact and contained)
                    )
                    hits["selected_successful_no_hit"].append(
                        int(exact and not contained)
                    )
                    hits["selected_failed_hit"].append(
                        int(not exact and contained)
                    )
                    hits["selected_failed_no_hit"].append(
                        int(not exact and not contained)
                    )
        for name, values in {**result, **hits}.items():
            log_dict.metrics[name] = float(np.mean(values)) if values else 0.0
        return log_dict

    def compute_DPR_scores(self, module, data_dict, log_dict) -> AttrDict:
        """Average precision/recall-at-K over per-question DPR results
        (reference: metrics_processors.py:467-495)."""
        batch_result = data_dict["batch_result"]
        ks = data_dict["Ks"]
        count = max(len(batch_result), 1)
        totals = {name: np.zeros(len(ks)) for name in (
            "precision", "recall", "gold_precision", "gold_recall",
        )}
        for entry in batch_result:
            for name in totals:
                totals[name] += np.asarray(entry[name]) / count
        for name, arr in totals.items():
            for index, k in enumerate(ks):
                log_dict.metrics[f"{name}_at_{k}"] = float(arr[index])
        return log_dict

    def write_predictions_to_file(self, module, data_dict, log_dict) -> AttrDict:
        """Dump predictions to answers.pkl in the results dir
        (reference: metrics_processors.py:446-464 wrote to cwd); over
        several processes rank 0 alone writes them."""
        if rank() != 0:
            return log_dict
        out_dir = self.config.get("results_path") or "."
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "answers.pkl")
        with open(path, "wb") as fh:
            pickle.dump(list(data_dict["batch_predictions"]), fh)
        logger.info("wrote predictions to %s", path)
        return log_dict
