"""Scalar metrics: counterpart of ``sct_gan_tpu/evals/metrics.py``.

``compute_metrics_for_threshold`` is numpy: the JAX package calls
scikit-learn there, which the card's machine does not have. Its PR-AUC and
ROC-AUC are scikit-learn's (``precision_recall_curve`` and ``roc_curve``
with their defaults, integrated by ``auc``), computed the same way."""
from __future__ import annotations

from typing import Dict

import numpy as np

VULNERABILITY_TYPES = [
    "ARTHM", "DOS", "LE", "RENT", "TimeM", "TimeO", "Tx-Origin", "UE",
]


def calculate_precision(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """TP / predicted-positive (notebook_utils.py:7-24)."""
    y_true = np.asarray(y_true).astype(bool)
    y_pred = np.asarray(y_pred).astype(bool)
    tp = np.sum(y_true & y_pred)
    pp = np.sum(y_pred)
    return float(tp / pp) if pp > 0 else 0.0


def calculate_recall(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """TP / actual-positive (notebook_utils.py:26-43)."""
    y_true = np.asarray(y_true).astype(bool)
    y_pred = np.asarray(y_pred).astype(bool)
    tp = np.sum(y_true & y_pred)
    ap = np.sum(y_true)
    return float(tp / ap) if ap > 0 else 0.0


def calculate_f1_score(precision: float, recall: float) -> float:
    """Harmonic mean (notebook_utils.py:45-59)."""
    if precision + recall == 0:
        return 0.0
    return 2 * (precision * recall) / (precision + recall)


def get_vulnerability_index(vuln_type: str) -> int:
    """Vuln-type → column index (notebook_utils.py:93-107)."""
    try:
        return VULNERABILITY_TYPES.index(vuln_type)
    except ValueError:
        return -1


def calculate_line_accuracy(true_line_vulns: np.ndarray,
                            pred_line_vulns: Dict[int, Dict[str, bool]]
                            ) -> float:
    """Accuracy of dict-form line predictions vs a (8, L) truth array
    (notebook_utils.py:61-91)."""
    true_line_vulns = np.asarray(true_line_vulns)
    correct = 0
    total = 0
    for line_idx, vulns in pred_line_vulns.items():
        for vuln_type, flag in vulns.items():
            j = get_vulnerability_index(vuln_type)
            if j < 0 or line_idx >= true_line_vulns.shape[1]:
                continue
            total += 1
            if bool(true_line_vulns[j, line_idx]) == bool(flag):
                correct += 1
    return correct / total if total > 0 else 0.0


def _binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray):
    """(fps, tps, thresholds) at each distinct score, descending: the
    false and true positives among the samples scored at or above it."""
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    ends = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[ends]
    return 1 + ends - tps, tps, y_score[ends]


def _auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoid area under (x, y), x monotone either way."""
    direction = -1.0 if np.all(np.diff(x) <= 0) else 1.0
    return float(direction * np.trapezoid(y, x))


def pr_auc_score(y_true: np.ndarray, y_probs: np.ndarray) -> float:
    """Area under the precision-recall curve: precision and recall at every
    distinct threshold, descending, ending at (recall 0, precision 1)."""
    fps, tps, _ = _binary_clf_curve(y_true, y_probs)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return _auc(np.r_[recall[::-1], 0.0], np.r_[precision[::-1], 1.0])


def roc_auc_score(y_true: np.ndarray, y_probs: np.ndarray) -> float:
    """Area under the ROC curve, its collinear inner points dropped and
    (0, 0) prepended. Without a negative sample the false-positive rate is
    undefined: NaN, as scikit-learn's curve gives it."""
    fps, tps, _ = _binary_clf_curve(y_true, y_probs)
    if fps[-1] <= 0:
        return float("nan")
    if fps.size > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    return _auc(np.r_[0, fps] / fps[-1], np.r_[0, tps] / tps[-1])


def compute_metrics_for_threshold(y_true: np.ndarray, y_pred: np.ndarray,
                                  y_probs: np.ndarray) -> Dict[str, float]:
    """Accuracy, precision, recall and F1 of ``y_pred`` (zero where a ratio
    is 0 / 0) and PR-AUC and ROC-AUC of ``y_probs``; all zeros when
    ``y_true`` has no positive."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    y_probs = np.asarray(y_probs).reshape(-1).astype(np.float64)
    if len(y_true) == 0 or np.sum(y_true) == 0:
        return {"accuracy": 0.0, "precision": 0.0, "recall": 0.0,
                "f1_score": 0.0, "pr_auc": 0.0, "roc_auc": 0.0}
    truth, pred = y_true == 1, y_pred == 1
    tp = float(np.sum(truth & pred))
    fp = float(np.sum(~truth & pred))
    fn = float(np.sum(truth & ~pred))
    positives = truth.astype(np.float64)
    return {"accuracy": float(np.mean(y_true == y_pred)),
            "precision": tp / (tp + fp) if tp + fp else 0.0,
            "recall": tp / (tp + fn) if tp + fn else 0.0,
            "f1_score": 2 * tp / (2 * tp + fp + fn) if tp else 0.0,
            "pr_auc": pr_auc_score(positives, y_probs),
            "roc_auc": roc_auc_score(positives, y_probs)}
