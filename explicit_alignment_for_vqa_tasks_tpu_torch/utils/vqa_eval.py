"""Official VQA accuracy protocol (reference: src/utils/vqaEval.py:12-173).

Accuracy per question = mean over the 10 human annotators of
``min(1, #other-annotators-matching-the-prediction / 3)``, after answer
normalization (punctuation stripping, number words -> digits, article
removal, contraction restoration). Normalization is only applied when the
10 ground-truth answers are not all identical — an official-protocol quirk
we preserve for exact score parity, as are the official code's regex and
replace-order idiosyncrasies noted inline. The normalization TABLES below
are the protocol spec itself (from GT-Vision-Lab/VQA) and must match
verbatim.

The port's own copy of explicit_alignment_for_vqa_tasks_tpu/utils/vqa_eval.py,
held against it by tests/test_torch_vqa_scoring.py. It has no native
scorer: the JAX package's C++ loop (``native/``) is not ported, since
this Python loop normalizes each distinct answer once and counts the
matches in one pass, and so scores VQA2 val's 214,354 questions in a
few seconds on one CPU core (tools/time_vqa_scoring.py).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

# --- official protocol data tables (spec, must match verbatim) --------------

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

ARTICLES = ("a", "an", "the")

PUNCT = (
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
    "-", ">", "<", "@", "`", ",", "?", "!",
)

# The official code's period regex is `(?!<=\d)(\.)(?!\d)` — the lookbehind
# is miswritten as a lookahead, so it matches any '.' not followed by a
# digit. Preserved verbatim: it is part of the de-facto protocol.
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")

# ---------------------------------------------------------------------------


def process_punctuation(text: str) -> str:
    """Strip punctuation per the official protocol.

    The official implementation tests conditions against the ORIGINAL
    string while replacing in the running output, and passes ``re.UNICODE``
    as the (positional) `count` argument of ``re.sub`` — both preserved.
    """
    out = text
    has_numeric_comma = _COMMA_STRIP.search(text) is not None
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or has_numeric_comma:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out, re.UNICODE)


def process_digit_article(text: str) -> str:
    """Lowercase; number words -> digits; drop articles; restore contractions."""
    words = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            words.append(word)
    return " ".join(CONTRACTIONS.get(w, w) for w in words)


def normalize_answer(text: str) -> str:
    """Full normalization pipeline (whitespace, punctuation, digit/article)."""
    text = text.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(text))


def _clean_ws(text: str) -> str:
    return text.replace("\n", " ").replace("\t", " ").strip()


class VQAEval:
    """Computes official VQA accuracies from a VQA object + result object."""

    def __init__(self, vqa, vqa_res, n: int = 2):
        self.n = n
        self.vqa = vqa
        self.vqa_res = vqa_res
        self.accuracy: Dict = {}
        self.evalQA: Dict[int, float] = {}
        self.evalQuesType: Dict[str, Dict[int, float]] = {}
        self.evalAnsType: Dict[str, Dict[int, float]] = {}
        self.params = {"question_id": vqa.get_ques_ids()}

    def _per_question_accuracies(self, ques_ids: Sequence[int]) -> List[float]:
        """Official per-question accuracy (reference: vqaEval.py:89-115),
        each distinct answer normalized once."""
        normalized: Dict[str, str] = {}
        out: List[float] = []
        for qid in ques_ids:
            gt = self.vqa.qa[qid]
            res_ans = _clean_ws(self.vqa_res.qa[qid]["answer"])
            gt_answers = [_clean_ws(a["answer"]) for a in gt["answers"]]

            # Normalization only applies when annotators disagree
            # (official quirk, reference: vqaEval.py:98-103).
            if len(set(gt_answers)) > 1:
                for text in (*gt_answers, res_ans):
                    if text not in normalized:
                        normalized[text] = process_digit_article(
                            process_punctuation(text))
                gt_answers = [normalized[a] for a in gt_answers]
                res_ans = normalized[res_ans]

            # annotator i's score counts the OTHER annotators that match
            hits = gt_answers.count(res_ans)
            per_annotator = [min(1.0, (hits - (a == res_ans)) / 3.0)
                             for a in gt_answers]
            out.append(sum(per_annotator) / len(per_annotator))
        return out

    def evaluate(self, ques_ids: Optional[Sequence[int]] = None) -> None:
        if ques_ids is None:
            ques_ids = list(self.params["question_id"])

        acc_qa: List[float] = []
        acc_ques_type: Dict[str, List[float]] = {}
        acc_ans_type: Dict[str, List[float]] = {}

        accuracies = self._per_question_accuracies(ques_ids)
        for qid, avg_acc in zip(ques_ids, accuracies):
            gt = self.vqa.qa[qid]
            ques_type = gt["question_type"]
            ans_type = gt["answer_type"]
            acc_qa.append(avg_acc)
            acc_ques_type.setdefault(ques_type, []).append(avg_acc)
            acc_ans_type.setdefault(ans_type, []).append(avg_acc)
            self.evalQA[qid] = round(100.0 * avg_acc, self.n)
            self.evalQuesType.setdefault(ques_type, {})[qid] = round(
                100.0 * avg_acc, self.n
            )
            self.evalAnsType.setdefault(ans_type, {})[qid] = round(
                100.0 * avg_acc, self.n
            )

        self.accuracy = {
            "overall": round(100.0 * sum(acc_qa) / len(acc_qa), self.n),
            "perQuestionType": {
                qt: round(100.0 * sum(v) / len(v), self.n)
                for qt, v in acc_ques_type.items()
            },
            "perAnswerType": {
                at: round(100.0 * sum(v) / len(v), self.n)
                for at, v in acc_ans_type.items()
            },
        }
