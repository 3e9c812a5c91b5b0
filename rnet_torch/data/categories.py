"""CLEVR question-category classification (count / exist / compare-numbers /
query-attribute / compare-attribute / other).

Own copy of ``rnet/data/categories.py`` (the port imports nothing of
``rnet``): the category of a question is the output function of its CLEVR
``program`` (its last node); without a program, a text-pattern fallback
classifies the question string. Both packages therefore report the same
families for the same questions.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

QUESTION_CATEGORIES: Tuple[str, ...] = (
    "count",
    "exist",
    "compare_numbers",
    "query_attribute",
    "compare_attribute",
    "other",
)

# CLEVR v1.0 program output functions -> category. The program's last node
# determines the question family (CLEVR paper, sec. 3: question types are
# named after the output function of the functional program).
_FUNC_TO_CATEGORY: Dict[str, str] = {
    "count": "count",
    "exist": "exist",
    "equal_integer": "compare_numbers",
    "greater_than": "compare_numbers",
    "less_than": "compare_numbers",
    "query_color": "query_attribute",
    "query_shape": "query_attribute",
    "query_material": "query_attribute",
    "query_size": "query_attribute",
    "equal_color": "compare_attribute",
    "equal_shape": "compare_attribute",
    "equal_material": "compare_attribute",
    "equal_size": "compare_attribute",
}


def _category_from_program(program: Sequence[dict]) -> str | None:
    if not program:
        return None
    last = program[-1]
    # CLEVR v1.0 uses "function"; some tooling re-emits it as "type".
    fn = last.get("function", last.get("type"))
    return _FUNC_TO_CATEGORY.get(fn) if fn else None


def _category_from_text(question: str) -> str:
    q = question.lower()
    # Order matters: comparison phrasings contain the query/exist prefixes.
    if ("more" in q or "fewer" in q or "less" in q) and " than " in q:
        return "compare_numbers"
    if "same number" in q or "equal number" in q or "same as the number" in q:
        return "compare_numbers"
    if "same color" in q or "same shape" in q or "same material" in q or "same size" in q:
        # "is X the same color as Y" -> compare; "things that are the same
        # color as X" inside count/exist questions are caught above/below
        if q.startswith("how many") or q.startswith("what number"):
            return "count"
        if q.startswith(("is there", "are there", "are any", "is any")):
            return "exist"
        return "compare_attribute"
    if q.startswith("how many") or q.startswith("what number"):
        return "count"
    if q.startswith(("is there", "are there", "are any", "is any", "does the scene contain")):
        return "exist"
    if q.startswith(("what color", "what shape", "what material", "what size", "what is the color",
                     "what is the shape", "what is the material", "what is the size")):
        return "query_attribute"
    if ("what" in q or "which" in q) and any(
        a in q for a in ("color", "shape", "material", "size", "made of")
    ):
        return "query_attribute"
    return "other"


def question_category(q: dict) -> str:
    """Category name for one question dict (program first, text fallback)."""
    cat = _category_from_program(q.get("program", ()))
    return cat if cat is not None else _category_from_text(q.get("question", ""))


def category_ids(questions: List[dict]) -> np.ndarray:
    """(N,) int32 of QUESTION_CATEGORIES indices, one per question."""
    idx = {c: i for i, c in enumerate(QUESTION_CATEGORIES)}
    return np.asarray([idx[question_category(q)] for q in questions], dtype=np.int32)
