"""`evaluate_model_performance` — the benchmark harness.

Counterpart of ``sct_gan_tpu/evals/harness.py``, itself in parity with the
notebook-only comprehensive evaluator
(final-model/validation process/model-performance-evaluation.ipynb cells
19-20, the source of all BASELINE.md numbers): per-contract detection at
threshold 0.0, **per-type contract thresholds** (baseline run: ARTHM 0.5,
rest 0.4) and **per-type line thresholds** (all 0.2), the empty-line
prob == 0.5 filter, flattening over actual lines only,
accuracy/P/R/F1/PR-AUC/ROC-AUC overall + per type (scikit-learn's
definitions, in numpy: ``metrics.py``), JSON dump.

Detection runs through the analyzer's batched forward (the reference runs
500 contracts strictly serially).
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np

from .metrics import compute_metrics_for_threshold

# thresholds of the published baseline run (eval notebook cell 20)
BASELINE_CONTRACT_THRESHOLDS = {"ARTHM": 0.5, "DOS": 0.4, "LE": 0.4,
                                "RENT": 0.4, "TimeM": 0.4, "TimeO": 0.4,
                                "Tx-Origin": 0.4, "UE": 0.4}
BASELINE_LINE_THRESHOLDS = {vt: 0.2 for vt in BASELINE_CONTRACT_THRESHOLDS}


def _best_f1_sweep(y_true: np.ndarray, probs: np.ndarray,
                   skip_half: bool = False) -> Dict[str, float]:
    """Best F1 over a threshold sweep (+ the argmax threshold).

    The protocol-pinned thresholds (eval notebook cell 20) are calibrated to
    the reference's probability scale; on a different corpus the ranking can
    be right while the fixed threshold is not. This reports the calibrated
    ceiling alongside — the same machinery cell 19 uses to pick thresholds.
    ``skip_half`` applies the empty-line filter (prob == 0.5 → never
    predicted, matching the pinned-threshold path)."""
    y = np.asarray(y_true).ravel() > 0
    p = np.asarray(probs).ravel()
    valid = ~(p == 0.5) if skip_half else np.ones_like(p, bool)
    best = {"threshold": 0.5, "f1_score": 0.0, "precision": 0.0,
            "recall": 0.0}
    for thr in np.arange(0.02, 0.99, 0.02):
        pred = (p > thr) & valid
        tp = float(np.sum(pred & y))
        fp = float(np.sum(pred & ~y))
        fn = float(np.sum(~pred & y))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        if f1 > best["f1_score"]:
            best = {"threshold": round(float(thr), 2), "f1_score": f1,
                    "precision": prec, "recall": rec}
    return best


def evaluate_model_performance(
    model_path: Optional[str] = None,
    val_dataloader=None,
    contract_thresholds: Optional[Dict[str, float]] = None,
    line_thresholds: Optional[Dict[str, float]] = None,
    max_contracts: Optional[int] = None,
    output_file: str = "comprehensive_evaluation_results.json",
    analyzer=None,
    verbose: bool = True,
) -> Dict[str, Any]:
    """Comprehensive evaluation with per-type thresholds.

    Pass either ``model_path`` (a checkpoint directory written by the
    port's trainer; the analyzer is then built on the card) or a prebuilt
    ``analyzer``."""
    log = print if verbose else (lambda *a, **k: None)
    if analyzer is None:
        from ..infer.analyzer import SmartContractAnalyzer
        analyzer = SmartContractAnalyzer(model_path=model_path, use_gan=True,
                                         verbose=verbose)
    vuln_types = analyzer.vulnerability_types
    if contract_thresholds is None:
        contract_thresholds = {vt: 0.2 for vt in vuln_types}
    if line_thresholds is None:
        line_thresholds = {vt: 0.2 for vt in vuln_types}

    dataset = getattr(val_dataloader, "dataset", val_dataloader)
    total = len(dataset.data)
    if max_contracts is not None:
        total = min(total, max_contracts)
    log(f"Evaluating {total} contracts "
        f"(contract thr {contract_thresholds}, line thr {line_thresholds})")

    results: Dict[str, Any] = {
        "model_info": {
            "model_path": model_path,
            "contract_thresholds": contract_thresholds,
            "line_thresholds": line_thresholds,
            "total_contracts": total,
            "vulnerability_types": vuln_types,
        },
        "contract_level": {"overall": {}, "per_vulnerability": {}},
        "line_level": {"overall": {}, "per_vulnerability": {},
                       "statistics": {"total_lines_processed": 0,
                                      "total_lines_with_vulnerabilities": 0,
                                      "total_lines_predicted_vulnerable": 0,
                                      "per_vulnerability": {}}},
    }

    codes = [dataset.data[i]["source_code"] for i in range(total)]
    # threshold 0.0 → raw probabilities; type thresholds applied below
    detections = analyzer.analyze_multiple_contracts(codes, threshold=0.0)

    contract_true, contract_pred, contract_probs = [], [], []
    line_true_all, line_pred_all, line_probs_all = [], [], []

    for idx in range(total):
        data = dataset.data[idx]
        det = detections[idx]
        true_c = np.asarray(data["contract_vulnerabilities"])
        true_l = np.asarray(data["vulnerable_lines"])          # (8, L)

        probs_c = np.asarray(det["contract_probabilities"][0])
        pred_c = np.array([1 if probs_c[j] > contract_thresholds[vt] else 0
                           for j, vt in enumerate(vuln_types)])
        contract_true.append(true_c)
        contract_pred.append(pred_c)
        contract_probs.append(probs_c)

        lines = data["source_code"].split("\n")
        n_lines = len(lines)
        lp = np.asarray(det["line_probabilities"][0])           # (Lslots, 8)
        line_pred = np.zeros((len(vuln_types), n_lines))
        line_probs = np.zeros((len(vuln_types), n_lines))
        upto = min(n_lines, lp.shape[0])
        for li in range(upto):
            for j, vt in enumerate(vuln_types):
                prob = lp[li, j]
                line_probs[j, li] = prob
                # empty-line filter: sigmoid(0) == 0.5 exactly marks slots
                # the model zeroed out (eval notebook cell 19)
                if prob != 0.5:
                    line_pred[j, li] = 1 if prob > line_thresholds[vt] else 0
        tl = true_l[:, :n_lines] if true_l.shape[1] > n_lines else true_l
        line_true_all.append(tl)
        line_pred_all.append(line_pred[:, :tl.shape[1]])
        line_probs_all.append(line_probs[:, :tl.shape[1]])

    contract_true = np.stack(contract_true)
    contract_pred = np.stack(contract_pred)
    contract_probs = np.stack(contract_probs)

    # flatten line arrays over actual lines (variable length per contract)
    flat_true = np.concatenate([x.reshape(-1) for x in line_true_all])
    flat_pred = np.concatenate([x.reshape(-1) for x in line_pred_all])
    flat_probs = np.concatenate([x.reshape(-1) for x in line_probs_all])

    stats = results["line_level"]["statistics"]
    stats["total_lines_processed"] = int(flat_true.size)
    stats["total_lines_with_vulnerabilities"] = int(np.sum(flat_true > 0))
    stats["total_lines_predicted_vulnerable"] = int(np.sum(flat_pred > 0))
    for j, vt in enumerate(vuln_types):
        t = np.concatenate([x[j] for x in line_true_all])
        p = np.concatenate([x[j] for x in line_pred_all])
        stats["per_vulnerability"][vt] = {
            "total_lines_processed": int(t.size),
            "total_lines_with_vulnerabilities": int(np.sum(t > 0)),
            "total_lines_predicted_vulnerable": int(np.sum(p > 0)),
        }

    results["contract_level"]["overall"] = compute_metrics_for_threshold(
        contract_true, contract_pred, contract_probs)
    for j, vt in enumerate(vuln_types):
        results["contract_level"]["per_vulnerability"][vt] = (
            compute_metrics_for_threshold(contract_true[:, j],
                                          contract_pred[:, j],
                                          contract_probs[:, j]))

    results["contract_level"]["overall"]["best_f1"] = _best_f1_sweep(
        contract_true, contract_probs)

    results["line_level"]["overall"] = compute_metrics_for_threshold(
        flat_true, flat_pred, flat_probs)
    results["line_level"]["overall"]["best_f1"] = _best_f1_sweep(
        flat_true, flat_probs, skip_half=True)
    for j, vt in enumerate(vuln_types):
        t = np.concatenate([x[j] for x in line_true_all])
        p = np.concatenate([x[j] for x in line_pred_all])
        pr = np.concatenate([x[j] for x in line_probs_all])
        results["line_level"]["per_vulnerability"][vt] = (
            compute_metrics_for_threshold(t, p, pr))
        results["line_level"]["per_vulnerability"][vt]["best_f1"] = (
            _best_f1_sweep(t, pr, skip_half=True))

    if output_file:
        with open(output_file, "w") as f:
            json.dump(results, f, indent=2, default=float)
        log(f"Results written to {output_file}")
    return results


def print_evaluation_summary(results: Dict[str, Any]) -> None:
    """Console report (eval notebook cell 19 `print_evaluation_summary`)."""
    print("=" * 70)
    print("COMPREHENSIVE EVALUATION RESULTS")
    print("=" * 70)
    for level in ("contract_level", "line_level"):
        o = results[level]["overall"]
        print(f"\n{level.replace('_', ' ').title()} — overall:")
        print(f"  acc={o['accuracy']:.4f} P={o['precision']:.4f} "
              f"R={o['recall']:.4f} F1={o['f1_score']:.4f} "
              f"PR-AUC={o['pr_auc']:.4f} ROC-AUC={o['roc_auc']:.4f}")
        if "best_f1" in o:
            b = o["best_f1"]
            print(f"  best-threshold F1: {b['f1_score']:.4f} at "
                  f"thr={b['threshold']:.2f} (P={b['precision']:.4f} "
                  f"R={b['recall']:.4f})")
        print(f"{'type':>10} {'acc':>8} {'P':>8} {'R':>8} {'F1':>8} "
              f"{'PR-AUC':>8}")
        for vt, m in results[level]["per_vulnerability"].items():
            print(f"{vt:>10} {m['accuracy']:8.4f} {m['precision']:8.4f} "
                  f"{m['recall']:8.4f} {m['f1_score']:8.4f} "
                  f"{m['pr_auc']:8.4f}")
    s = results["line_level"]["statistics"]
    print(f"\nLine slots: {s['total_lines_processed']:,}  "
          f"true-vulnerable: {s['total_lines_with_vulnerabilities']:,}  "
          f"predicted: {s['total_lines_predicted_vulnerable']:,}")
