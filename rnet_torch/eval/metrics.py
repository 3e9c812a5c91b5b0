"""Evaluation metrics: overall / per-answer / per-answer-class /
per-question-family accuracy, mean NLL and the confusion matrix.

Port of ``rnet/eval/metrics.py``: ``EvalAccumulator`` accumulates host-side
numpy predictions batch by batch and ``dump`` writes the same reports into
the results dir (``<tag>_accuracy.csv``, ``<tag>_confusion.csv`` and, where
matplotlib is installed, ``<tag>_confusion.png``).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np

from ..data.categories import QUESTION_CATEGORIES
from ..data.vocab import Dictionaries, answer_class


class EvalAccumulator:
    """Streaming accumulator over eval batches (host side, numpy).

    ``categories`` is an optional (n_questions,) int32 array mapping question
    index -> QUESTION_CATEGORIES id (from ``dataset.question_categories()``);
    when present and ``update`` receives the batch's question indices, the
    reference-style per-question-family table is accumulated alongside the
    answer-value confusion matrix.
    """

    def __init__(self, dicts: Dictionaries, categories: Optional[np.ndarray] = None):
        self.dicts = dicts
        n = dicts.n_answers
        self.confusion = np.zeros((n, n), dtype=np.int64)  # [true, pred]
        self.categories = None if categories is None else np.asarray(categories)
        self.cat_hits = np.zeros(len(QUESTION_CATEGORIES), dtype=np.int64)
        self.cat_totals = np.zeros(len(QUESTION_CATEGORIES), dtype=np.int64)
        self.nll_sum = 0.0
        self.n = 0

    def update(self, pred, labels, valid, nll_sum=0.0, qidx=None) -> None:
        pred = np.asarray(pred).ravel()
        labels = np.asarray(labels).ravel()
        valid = np.asarray(valid).ravel().astype(bool)
        t, p = labels[valid], pred[valid]
        np.add.at(self.confusion, (t, p), 1)
        if qidx is not None and self.categories is not None:
            cat = self.categories[np.asarray(qidx).ravel()[valid]]
            np.add.at(self.cat_totals, cat, 1)
            np.add.at(self.cat_hits, cat[t == p], 1)
        self.nll_sum += float(nll_sum)
        self.n += int(valid.sum())

    @property
    def accuracy(self) -> float:
        return float(np.trace(self.confusion)) / max(self.n, 1)

    @property
    def mean_nll(self) -> float:
        return self.nll_sum / max(self.n, 1)

    def per_answer_accuracy(self) -> Dict[str, float]:
        out = {}
        for a, i in self.dicts.answer_to_idx.items():
            total = self.confusion[i].sum()
            if total:
                out[a] = float(self.confusion[i, i]) / total
        return out

    def per_class_accuracy(self) -> Dict[str, float]:
        """Accuracy grouped into CLEVR answer classes (number/exist/...)."""
        hits: Dict[str, List[int]] = {}
        for a, i in self.dicts.answer_to_idx.items():
            cls = answer_class(a)
            h = hits.setdefault(cls, [0, 0])
            h[0] += int(self.confusion[i, i])
            h[1] += int(self.confusion[i].sum())
        return {c: (h / t if t else float("nan")) for c, (h, t) in hits.items()}

    def per_category_accuracy(self) -> Dict[str, float]:
        """Accuracy per question family (reference test.py table shape).

        Empty unless the accumulator was built with per-question categories
        AND updates carried question indices. Families with zero questions
        are omitted.
        """
        out = {}
        for i, name in enumerate(QUESTION_CATEGORIES):
            if self.cat_totals[i]:
                out[name] = float(self.cat_hits[i]) / float(self.cat_totals[i])
        return out

    # ---- report dumps (reference: csv + png into --test-results-dir) ----

    def dump(self, results_dir: str, tag: str = "val") -> Dict[str, str]:
        os.makedirs(results_dir, exist_ok=True)
        paths = {}

        acc_csv = os.path.join(results_dir, f"{tag}_accuracy.csv")
        with open(acc_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["metric", "value"])
            w.writerow(["overall_accuracy", f"{self.accuracy:.6f}"])
            w.writerow(["mean_nll", f"{self.mean_nll:.6f}"])
            for c, v in sorted(self.per_category_accuracy().items()):
                w.writerow([f"category_{c}", f"{v:.6f}"])
            for c, v in sorted(self.per_class_accuracy().items()):
                w.writerow([f"class_{c}", f"{v:.6f}"])
            for a, v in sorted(self.per_answer_accuracy().items()):
                w.writerow([f"answer_{a}", f"{v:.6f}"])
        paths["accuracy_csv"] = acc_csv

        cm_csv = os.path.join(results_dir, f"{tag}_confusion.csv")
        answers = [self.dicts.idx_to_answer[i] for i in range(self.dicts.n_answers)]
        with open(cm_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["true\\pred", *answers])
            for i, a in enumerate(answers):
                w.writerow([a, *self.confusion[i].tolist()])
        paths["confusion_csv"] = cm_csv

        try:  # the confusion heatmap needs matplotlib, which is optional
            import matplotlib
        except ImportError:
            return paths
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 8))
        denom = self.confusion.sum(1, keepdims=True).clip(min=1)
        ax.imshow(self.confusion / denom, cmap="viridis")
        ax.set_xticks(range(len(answers)))
        ax.set_xticklabels(answers, rotation=90, fontsize=6)
        ax.set_yticks(range(len(answers)))
        ax.set_yticklabels(answers, fontsize=6)
        ax.set_xlabel("predicted")
        ax.set_ylabel("true")
        ax.set_title(f"{tag} confusion (row-normalized)")
        png = os.path.join(results_dir, f"{tag}_confusion.png")
        fig.tight_layout()
        fig.savefig(png, dpi=120)
        plt.close(fig)
        paths["confusion_png"] = png
        return paths
