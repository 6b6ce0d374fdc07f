"""The port's official VQA scoring (utils/vqa_eval.py, utils/vqa_tools.py,
trainers/metrics_processors.py) against the JAX package's on the CPU:
answer normalisation and per-question accuracies bit-equal to both of the
JAX package's scorers (its Python twin and its native one) on a seeded
answer corpus (numbers, articles, punctuation, contractions), edge cases
of the annotator count, the timing tool's official-shape loop, and the
executor's metric functions on the synthetic VQA2 files."""

import json
import logging
import os
import pickle

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu import native as jnative  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.registry import DATA_LOADERS as JDL  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.trainers import metrics_processors as jmp  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.utils import vqa_eval as jeval  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.utils import vqa_tools as jtools  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.registry import DATA_LOADERS as TDL  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import time_vqa_scoring  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import metrics_processors as tmp_  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.utils import vqa_eval as teval  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.utils import vqa_tools as ttools  # noqa: E402
from test_e2e import make_test_config, write_vqa_fixtures  # noqa: E402
from test_torch_eval_data import port_config  # noqa: E402

PIECES = [
    "two", "Two", "ten", "none", "zero", "2", "10", "1,000", "9,999", "3.5",
    "a", "an", "the", "The", "A", "dont", "isnt", "yall", "hes", "Im",
    "won't", "oclock", "yes", "no", "red", "blue", "cat", "dogs", "a.m.",
    "yes.", "no!", "(red)", "[blue]", "red/blue", "x@y", "what?", "it's",
    "well-done", "semi;colon", '"quoted"', "back\\slash", "under_score",
    "e.g", ".", ",", ";", "-", "!", "?", "\n", "\t", "",
]
SEPARATORS = [" ", " ", " ", "", ".", ",", " - ", "; "]


def corpus(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 5))
        parts = [PIECES[i] for i in rng.integers(0, len(PIECES), k)]
        seps = [SEPARATORS[i] for i in rng.integers(0, len(SEPARATORS), k)]
        text = "".join(p + s for p, s in zip(parts, seps))
        if rng.random() < 0.3:
            text = " " + text.upper() + " "
        out.append(text)
    return out


def test_protocol_tables_equal_jax():
    assert teval.CONTRACTIONS == jeval.CONTRACTIONS
    assert teval.MANUAL_MAP == jeval.MANUAL_MAP
    assert teval.ARTICLES == jeval.ARTICLES
    assert teval.PUNCT == jeval.PUNCT


@pytest.mark.parametrize("seed", [0, 1])
def test_normalization_equals_jax_and_native(seed):
    for text in corpus(seed, 400):
        want = jeval.normalize_answer(text)
        assert teval.normalize_answer(text) == want, text
        assert (teval.process_punctuation(text)
                == jeval.process_punctuation(text)), text
        assert (teval.process_digit_article(text)
                == jeval.process_digit_article(text)), text
        assert jnative.normalize_answer_native(text) == want, text


def write_vqa_files(tmp_path, seed: int, n: int = 300):
    """n questions with ten answers each, drawn from a small pool per
    question so that annotators agree and disagree; seeded predictions,
    half of them variants of an annotator's answer."""
    rng = np.random.default_rng(seed)
    words = corpus(seed + 100, 60)
    annotations, questions, predictions = [], [], []
    for q in range(n):
        pool = [words[i] for i in rng.integers(0, len(words), 3)]
        if q % 7 == 0:
            answers = [pool[0]] * 10           # unanimous: no normalisation
        else:
            answers = [pool[i] for i in rng.integers(0, 3, 10)]
        annotations.append({
            "question_id": q, "image_id": q // 3,
            "question_type": ["what color is", "how many", "is the"][q % 3],
            "answer_type": ["other", "number", "yes/no"][q % 3],
            "multiple_choice_answer": answers[0],
            "answers": [{"answer": a, "answer_confidence": "yes",
                         "answer_id": i + 1} for i, a in enumerate(answers)],
        })
        questions.append({"question_id": q, "image_id": q // 3,
                          "question": f"question {q} ?"})
        pick = answers[int(rng.integers(0, 10))]
        variants = [pick, pick.upper(), f" {pick}. ", f"the {pick}",
                    words[int(rng.integers(0, len(words)))]]
        predictions.append({"question_id": q,
                            "answer": variants[int(rng.integers(0, 5))]})
    meta = {"info": {}, "task_type": "Open-Ended", "data_type": "mscoco",
            "data_subtype": "val2014", "license": {}}
    ann = tmp_path / "annotations.json"
    ques = tmp_path / "questions.json"
    ann.write_text(json.dumps({**meta, "annotations": annotations}))
    ques.write_text(json.dumps({**meta, "questions": questions}))
    return str(ann), str(ques), predictions


def evaluate(tools, evalmod, ann, ques, predictions, **kwargs):
    vqa = tools.VQA(ann, ques)
    res = vqa.load_res_from_list(list(predictions))
    ev = evalmod.VQAEval(vqa, res, n=2, **kwargs)
    ev.evaluate()
    return ev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accuracies_equal_jax_native_and_python(tmp_path, seed):
    """The port's one scorer against both of the JAX package's."""
    ann, ques, predictions = write_vqa_files(tmp_path, seed)
    got = evaluate(ttools, teval, ann, ques, predictions)
    assert 0 < got.accuracy["overall"] < 100
    for use_native in (False, True):
        want = evaluate(jtools, jeval, ann, ques, predictions,
                        use_native=use_native)
        assert got.accuracy == want.accuracy
        assert got.evalQA == want.evalQA
        assert got.evalQuesType == want.evalQuesType
        assert got.evalAnsType == want.evalAnsType


class _Answers(time_vqa_scoring._Answers):
    def __init__(self, gt_lists, predictions):
        super().__init__({q: {"answers": [{"answer": a} for a in answers],
                              "question_type": "t", "answer_type": "a"}
                          for q, answers in enumerate(gt_lists)})
        self.res = time_vqa_scoring._Answers(
            {q: {"answer": p} for q, p in enumerate(predictions)})


@pytest.mark.parametrize("gt_lists,predictions,want", [
    # unanimous; 3 of 10 match (each matching annotator sees 2 others);
    # normalised "two" = "2"
    ([["yes"] * 10, ["cat"] * 3 + ["dog"] * 7, ["two"] * 5 + ["2"] * 5],
     ["yes", "cat", "2"], [1.0, 0.9, 1.0]),
    # the annotator count is the question's own, as in the official code
    ([["a"] * 9 + ["b"], ["x", "y"], ["c"] * 4],
     ["A.", "x", "c"], [1.0, 1 / 6, 1.0]),
])
def test_scorer_edge_cases_equal_jax(gt_lists, predictions, want):
    vqa = _Answers(gt_lists, predictions)
    got = teval.VQAEval(vqa, vqa.res, n=2)._per_question_accuracies(
        vqa.get_ques_ids())
    np.testing.assert_allclose(got, want)
    jgot = jeval.VQAEval(vqa, vqa.res, n=2, use_native=False)
    assert got == jgot._per_question_accuracies(vqa.get_ques_ids())


def test_timing_tool_scores_as_the_official_loop(capsys):
    out = time_vqa_scoring.main(["--questions", "3000", "--seed", "1"])
    assert json.loads(capsys.readouterr().out.strip()) == out
    assert out["questions"] == 3000 and 0 < out["accuracy_overall"] < 100
    vqa, res = time_vqa_scoring.synthetic_val(300, 2)
    ev = teval.VQAEval(vqa, res, n=2)
    assert (ev._per_question_accuracies(vqa.get_ques_ids())
            == time_vqa_scoring.official_shape(vqa, res))


def test_result_coverage_is_checked_as_in_jax(tmp_path):
    ann, ques, predictions = write_vqa_files(tmp_path, 0, n=20)
    for tools in (ttools, jtools):
        vqa = tools.VQA(ann, ques)
        with pytest.raises(AssertionError, match="missing=1"):
            vqa.load_res_from_list(predictions[1:])
        assert (vqa.get_ques_ids(ques_types="how many")
                == jtools.VQA(ann, ques).get_ques_ids(ques_types="how many"))
        assert vqa.get_img_ids(ques_ids=[3, 4]) == [1, 1]


class Scorer:
    """The metrics mixin as an executor mixes it in."""

    def __init__(self, mixin, config, data_loader):
        self.obj = type("S", (mixin,), {})()
        self.obj.config = config
        self.obj.data_loader = data_loader
        self.obj.in_sanity_check = False


def metric_scorers(tmp_path):
    fixtures = write_vqa_fixtures(tmp_path, n_val_imgs=9)
    jconfig = make_test_config(tmp_path, fixtures)
    jconfig.metrics = [{"name": "compute_vqa_scores"},
                       {"name": "compute_accuracy"},
                       {"name": "write_predictions_to_file"}]
    tconfig = port_config(jconfig, tmp_path)
    out = []
    for registry, config, mixin in ((JDL, jconfig, jmp.MetricsProcessor),
                                    (TDL, tconfig, tmp_.MetricsProcessor)):
        data_loader = registry.get(config.data_loader.type)(config)
        data_loader.build_dataset()
        out.append(Scorer(mixin, config, data_loader).obj)
    return out


def test_executor_metrics_equal_jax(tmp_path):
    """compute_vqa_scores, compute_accuracy and write_predictions_to_file
    through the mixin, on predictions of which some are right."""
    jscorer, tscorer = metric_scorers(tmp_path)
    items = jscorer.data_loader.data.vqa_data.val.data_items
    predictions = [{"question_id": item.question_id,
                    "answer": item.gold_answer if i % 3 else "no"}
                   for i, item in enumerate(items)]
    results = []
    for scorer in (jscorer, tscorer):
        log_dict = scorer.compute_metrics(
            {"mode": "test", "epoch": 0, "batch_predictions": predictions})
        with open(os.path.join(scorer.config.results_path, "answers.pkl"),
                  "rb") as fh:
            results.append((dict(log_dict.metrics), pickle.load(fh)))
    (jmetrics, janswers), (tmetrics, tanswers) = results
    assert tmetrics == jmetrics
    assert 0 < tmetrics["accuracy_overall"] < 100
    assert tmetrics["accuracy_QuestionType_what color is"] == \
        tmetrics["accuracy_overall"]
    assert tanswers == janswers == predictions


def test_scoring_failure_is_logged_not_raised_as_in_jax(tmp_path, caplog):
    """A prediction set that misses a question fails the protocol's
    coverage check: both packages log it and leave accuracy_overall out,
    so callers must check for it."""
    jscorer, tscorer = metric_scorers(tmp_path)
    items = jscorer.data_loader.data.vqa_data.val.data_items[1:]
    predictions = [{"question_id": item.question_id, "answer": "red"}
                   for item in items]
    for scorer in (jscorer, tscorer):
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            log_dict = scorer.compute_metrics(
                {"mode": "test", "epoch": 0,
                 "batch_predictions": predictions})
        assert "accuracy_overall" not in log_dict.metrics
        assert "failed to compute VQA scores" in caplog.text
