"""Tokenizer loading + an offline fallback tokenizer.

The reference instantiates HF tokenizers by class-name string from config
(reference: src/data_loader_manager/data_loader_wrapper.py:43-62). We keep
that contract via `load_tokenizer`. For hermetic tests and offline smoke
runs we additionally provide `SimpleTokenizer`, a whitespace tokenizer that
reproduces the T5 conventions the pipeline depends on:

  * ``<extra_id_i>`` sentinels map to ids ``32099 - i`` (T5 vocabulary
    layout — the prefix-splice op keys on these ids,
    reference: src/models/vct0.py:506-509)
  * pad=0, eos=1 ("</s>"), unk=2; eos appended like T5
  * left/right padding sides, max_length truncation

The port's own copy of explicit_alignment_for_vqa_tasks_tpu/data/tokenization.py,
held against it by tests/test_torch_eval_data.py. ``transformers`` is
imported only when a config names an HF tokenizer class. SimpleTokenizer
interns new words under a lock, since collate threads call it at once; the
ids it gives still follow the order in which words are first seen.
"""

from __future__ import annotations

import copy
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

# id of <extra_id_0>; <extra_id_i> = T5_SENTINEL_BASE - i
from ..ops.prefix_splice import T5_SENTINEL_BASE

_SENTINEL_RE = re.compile(r"<extra_id_(\d+)>")


class Encoding(dict):
    """dict with attribute access (mirrors the HF BatchEncoding surface)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc


class SimpleTokenizer:
    """Deterministic whitespace tokenizer with a T5-compatible id layout.

    Words are assigned ids on first use starting at 1000 (so they never
    collide with specials or sentinel ids). Not a linguistic tokenizer —
    a drop-in for tests and offline pipeline smoke runs only.
    """

    def __init__(self, vocab_size: int = 32128, append_eos: bool = True):
        self.vocab_size = vocab_size
        self.append_eos = append_eos
        self.pad_token = "<pad>"
        self.eos_token = "</s>"
        self.unk_token = "<unk>"
        self.bos_token = None
        self.pad_token_id = 0
        self.eos_token_id = 1
        self.unk_token_id = 2
        self.bos_token_id = None
        self.padding_side = "right"
        self.additional_special_tokens: List[str] = [
            f"<extra_id_{i}>" for i in range(100)
        ]
        self._word_to_id: Dict[str, int] = {}
        self._id_to_word: Dict[int, str] = {
            0: self.pad_token, 1: self.eos_token, 2: self.unk_token,
        }
        for i in range(100):
            self._id_to_word[T5_SENTINEL_BASE - i] = f"<extra_id_{i}>"
        self._next_id = 1000
        self._intern_lock = threading.Lock()

    # -- vocab -------------------------------------------------------------
    def add_special_tokens(self, special_tokens: Dict[str, Any]) -> int:
        added = 0
        for key, value in special_tokens.items():
            if key == "additional_special_tokens":
                for tok in value:
                    if tok not in self.additional_special_tokens:
                        self.additional_special_tokens.append(tok)
                        self._intern(tok)
                        added += 1
            elif value is not None:
                setattr(self, key, value)
                tok_id = self._intern(value)
                setattr(self, key.replace("_token", "_token_id"), tok_id)
                added += 1
        return added

    def _intern(self, word: str) -> int:
        match = _SENTINEL_RE.fullmatch(word)
        if match:
            return T5_SENTINEL_BASE - int(match.group(1))
        if word == self.pad_token:
            return self.pad_token_id
        if word == self.eos_token:
            return self.eos_token_id
        with self._intern_lock:
            if word not in self._word_to_id:
                self._word_to_id[word] = self._next_id
                self._id_to_word[self._next_id] = word
                self._next_id += 1
            return self._word_to_id[word]

    def __len__(self) -> int:
        return self.vocab_size

    # -- encode ------------------------------------------------------------
    _SPECIAL_RE = re.compile(r"<extra_id_\d+>|<pad>|</s>|<unk>")

    def tokenize_to_ids(self, text: str) -> List[int]:
        # split out special tokens (sentinels, <pad>, </s>) so they stay
        # atomic even when embedded without surrounding whitespace
        ids: List[int] = []
        pos = 0
        for match in self._SPECIAL_RE.finditer(text):
            ids.extend(
                self._intern(w) for w in text[pos:match.start()].split()
            )
            tok = match.group(0)
            sent = _SENTINEL_RE.fullmatch(tok)
            if sent:
                ids.append(T5_SENTINEL_BASE - int(sent.group(1)))
            elif tok == "<pad>":
                ids.append(self.pad_token_id)
            elif tok == "</s>":
                ids.append(self.eos_token_id)
            else:
                ids.append(self.unk_token_id)
            pos = match.end()
        ids.extend(self._intern(w) for w in text[pos:].split())
        return ids

    def __call__(
        self,
        texts: Union[str, Sequence[str]],
        padding: Union[bool, str] = "longest",
        max_length: Optional[int] = None,
        truncation: bool = False,
        pad_to_multiple_of: Optional[int] = None,
        return_tensors: Optional[str] = "np",
        padding_side: Optional[str] = None,
        **_: Any,
    ) -> Encoding:
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        seqs = []
        for text in texts:
            ids = self.tokenize_to_ids(text)
            if self.append_eos:
                ids = ids + [self.eos_token_id]
            if truncation and max_length is not None:
                ids = ids[:max_length]
            seqs.append(ids)

        target = max((len(s) for s in seqs), default=0)
        if padding == "max_length" and max_length is not None:
            target = max_length
        if pad_to_multiple_of:
            target = -(-target // pad_to_multiple_of) * pad_to_multiple_of

        side = padding_side or self.padding_side
        input_ids, attention_mask = [], []
        for ids in seqs:
            n_pad = target - len(ids)
            pads = [self.pad_token_id] * n_pad
            ones, zeros = [1] * len(ids), [0] * n_pad
            if side == "left":
                input_ids.append(pads + ids)
                attention_mask.append(zeros + ones)
            else:
                input_ids.append(ids + pads)
                attention_mask.append(ones + zeros)
        if return_tensors == "np":
            return Encoding(
                input_ids=np.asarray(input_ids, dtype=np.int32),
                attention_mask=np.asarray(attention_mask, dtype=np.int32),
            )
        return Encoding(input_ids=input_ids, attention_mask=attention_mask)

    # -- decode ------------------------------------------------------------
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        words = []
        for i in np.asarray(ids).reshape(-1).tolist():
            if i < 0:
                continue
            word = self._id_to_word.get(int(i), self.unk_token)
            if skip_special_tokens and (
                i in (self.pad_token_id, self.eos_token_id)
                or _SENTINEL_RE.fullmatch(word)
            ):
                continue
            words.append(word)
        return " ".join(words)

    def batch_decode(
        self, batch_ids: Sequence[Sequence[int]], skip_special_tokens: bool = True
    ) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch_ids]

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        if isinstance(tokens, str):
            return self._intern(tokens)
        return [self._intern(t) for t in tokens]


class ThreadSafeTokenizer:
    """Thread-local copies of an HF *fast* tokenizer.

    Fast tokenizers mutate shared Rust state on every call
    (``set_truncation_and_padding``) and raise ``RuntimeError: Already
    borrowed`` when collate threads call them concurrently. Each thread
    transparently gets its own deepcopy. Attribute writes and
    ``add_special_tokens`` (the only mutators used at setup time, e.g.
    ``tokenizer.pad_token = tokenizer.eos_token``) broadcast to the base
    and every existing copy so all threads observe them.
    """

    def __init__(self, base: Any):
        import threading

        d = object.__getattribute__(self, "__dict__")
        d["_base"] = base
        d["_local"] = threading.local()
        d["_assigned"] = {}   # thread ident -> copy (live threads)
        d["_free"] = []       # reclaimed copies awaiting reuse
        d["_lock"] = threading.Lock()

    def _tok(self) -> Any:
        tok = getattr(self._local, "tok", None)
        if tok is None:
            import threading

            with self._lock:
                # reclaim copies whose owner thread has exited — pools
                # are recreated per epoch/eval pass, so without this the
                # deepcopies would accumulate for the process lifetime
                live = {t.ident for t in threading.enumerate()}
                for ident in [i for i in self._assigned if i not in live]:
                    self._free.append(self._assigned.pop(ident))
                tok = (self._free.pop() if self._free
                       else copy.deepcopy(self._base))
                self._assigned[threading.get_ident()] = tok
            self._local.tok = tok
        return tok

    def _all_copies(self):
        return list(self._assigned.values()) + list(self._free)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._tok(), name)

    def __setattr__(self, name: str, value: Any) -> None:
        with self._lock:
            setattr(self._base, name, value)
            for tok in self._all_copies():
                setattr(tok, name, value)

    def add_special_tokens(self, *args: Any, **kwargs: Any) -> int:
        with self._lock:
            added = self._base.add_special_tokens(*args, **kwargs)
            for tok in self._all_copies():
                tok.add_special_tokens(*args, **kwargs)
        return added

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self._tok()(*args, **kwargs)

    def __len__(self) -> int:
        return len(self._tok())


def load_tokenizer(
    tokenizer_class: str, model_version: str, special_tokens: Optional[Dict] = None
) -> Any:
    """Instantiate a tokenizer by config class name.

    ``SimpleTokenizer`` is resolved locally; anything else goes through
    HuggingFace transformers (AutoTokenizer / T5Tokenizer / GPT2Tokenizer /
    BertTokenizer, reference: data_loader_wrapper.py:43-62), from local
    files only: the port downloads nothing.
    """
    if tokenizer_class == "SimpleTokenizer":
        tokenizer = SimpleTokenizer()
    else:
        import transformers

        cls = getattr(transformers, tokenizer_class)
        tokenizer = cls.from_pretrained(model_version, local_files_only=True)
    if special_tokens:
        merged = dict(special_tokens)
        merged["additional_special_tokens"] = list(
            getattr(tokenizer, "additional_special_tokens", [])
        ) + list(special_tokens.get("additional_special_tokens", []))
        tokenizer.add_special_tokens(merged)
    if getattr(tokenizer, "is_fast", False):
        tokenizer = ThreadSafeTokenizer(tokenizer)
    return tokenizer
