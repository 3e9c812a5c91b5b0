"""Question/answer vocabulary building and tokenization.

Port of ``rnet/data/vocab.py`` (kept as an own copy: the port imports nothing
of ``rnet``). Same regex tokenizer, 1-based word ids with 0 as padding,
first-seen-order answer ids, the same pickle cache inside the CLEVR dir, and
the same out-of-vocabulary policies.
"""

from __future__ import annotations

import json
import os
import pickle
import re
from typing import Dict, List, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"\w+|[^\w\s]")

PAD_ID = 0

CLEVR_COLORS = ("blue", "brown", "cyan", "gray", "green", "purple", "red", "yellow")
CLEVR_SHAPES = ("cube", "cylinder", "sphere")
CLEVR_MATERIALS = ("metal", "rubber")
CLEVR_SIZES = ("large", "small")
CLEVR_NUMBERS = tuple(str(i) for i in range(11))
CLEVR_BOOLS = ("no", "yes")

ANSWER_CLASSES: Dict[str, Tuple[str, ...]] = {
    "number": CLEVR_NUMBERS,
    "exist": CLEVR_BOOLS,
    "color": CLEVR_COLORS,
    "shape": CLEVR_SHAPES,
    "material": CLEVR_MATERIALS,
    "size": CLEVR_SIZES,
}


def answer_class(answer: str) -> str:
    for cls, values in ANSWER_CLASSES.items():
        if answer in values:
            return cls
    return "other"


def tokenize(sentence: str) -> List[str]:
    """Lowercase regex tokenization; strips ``?`` and ``;``."""
    s = sentence.lower().replace("?", "").replace(";", "")
    return _TOKEN_RE.findall(s)


class Dictionaries:
    """word->idx (1-based; 0=pad) and answer->idx maps + inverses.

    ``oov``: "error" raises KeyError on a word outside the train vocabulary,
    "unk" maps it to a dedicated index (vocab_size grows by 1), "drop" skips it.
    """

    OOV_POLICIES = ("error", "unk", "drop")

    def __init__(
        self,
        word_to_idx: Dict[str, int],
        answer_to_idx: Dict[str, int],
        oov: str = "error",
    ):
        if oov not in self.OOV_POLICIES:
            raise ValueError(f"oov must be one of {self.OOV_POLICIES}, got {oov!r}")
        self.word_to_idx = word_to_idx
        self.answer_to_idx = answer_to_idx
        self.oov = oov
        self.idx_to_word = {v: k for k, v in word_to_idx.items()}
        self.idx_to_answer = {v: k for k, v in answer_to_idx.items()}

    @property
    def unk_id(self) -> int | None:
        return len(self.word_to_idx) + 1 if self.oov == "unk" else None

    @property
    def vocab_size(self) -> int:
        # +1 for the padding index 0 (+1 more for UNK under oov="unk").
        return len(self.word_to_idx) + 1 + (1 if self.oov == "unk" else 0)

    @property
    def n_answers(self) -> int:
        return len(self.answer_to_idx)

    def encode_question(self, question: str, max_len: int | None = None) -> np.ndarray:
        """Tokenize + map to int32 ids; optionally pad/truncate to max_len."""
        if self.oov == "drop":
            ids = [self.word_to_idx[w] for w in tokenize(question) if w in self.word_to_idx]
        elif self.oov == "unk":
            unk = self.unk_id
            ids = [self.word_to_idx.get(w, unk) for w in tokenize(question)]
        else:
            ids = [self.word_to_idx[w] for w in tokenize(question)]
        if max_len is not None:
            ids = ids[:max_len] + [PAD_ID] * max(0, max_len - len(ids))
        return np.asarray(ids, dtype=np.int32)

    def encode_answer(self, answer: str) -> int:
        try:
            return self.answer_to_idx[answer]
        except KeyError:
            raise KeyError(
                f"answer {answer!r} is not in the model's answer vocabulary "
                f"({sorted(self.answer_to_idx)}) — checkpoint/data mismatch?"
            ) from None

    def answer_classes(self) -> Dict[int, str]:
        """idx -> class name, for per-class accuracy reporting."""
        return {i: answer_class(a) for a, i in self.answer_to_idx.items()}


def _cache_path(clevr_dir: str) -> str:
    return os.path.join(clevr_dir, "rnet_dictionaries.pkl")


def build_dictionaries(
    clevr_dir: str, use_cache: bool = True, oov: str = "error"
) -> Dictionaries:
    """Scan the train questions JSON once; cache the result as a pickle.

    The cache file is the one ``rnet`` writes, so both packages agree on the
    word/answer ids of a data dir.
    """
    cache = _cache_path(clevr_dir)
    if use_cache and os.path.exists(cache):
        with open(cache, "rb") as f:
            word_to_idx, answer_to_idx = pickle.load(f)
        return Dictionaries(word_to_idx, answer_to_idx, oov=oov)

    qpath = os.path.join(clevr_dir, "questions", "CLEVR_train_questions.json")
    with open(qpath) as f:
        questions = json.load(f)["questions"]

    word_to_idx: Dict[str, int] = {}
    answer_to_idx: Dict[str, int] = {}
    for q in questions:
        for w in tokenize(q["question"]):
            if w not in word_to_idx:
                word_to_idx[w] = len(word_to_idx) + 1  # 0 is pad
        a = str(q["answer"]).lower()
        if a not in answer_to_idx:
            answer_to_idx[a] = len(answer_to_idx)

    if use_cache:
        try:
            with open(cache, "wb") as f:
                pickle.dump((word_to_idx, answer_to_idx), f)
        except OSError:
            pass  # read-only data dir: skip caching
    return Dictionaries(word_to_idx, answer_to_idx, oov=oov)


def invert_questions(q: np.ndarray) -> np.ndarray:
    """Reverse token order along the last axis (reference --invert-questions):
    padding ends up first and the real tokens last."""
    return np.ascontiguousarray(q[..., ::-1])
