"""Validation sweeps and detection-quality metrics.

Counterpart of ``sct_gan_tpu/evals/validation.py``, itself in parity with
SCT-GAN/notebook_utils.py:
  * `collect_validation_results` (:430-742) — true/pred (8, 1024) arrays,
    line mappings, vulnerable-line extraction, generation success rate;
  * `compute_contract_level_metrics` (:779-863) — PR-AUC/accuracy per type;
  * `compute_line_level_metrics` (:1134-1296) — line PR-AUC/recall per type;
  * `analyze_line_vulnerability_detection` (:1298-1443) — TP/FP/FN analysis;
  * the summary printers.

Detection runs in batches through the analyzer (the reference analyzes
each contract serially through a fresh forward). A generation that the
port refuses as bad input (``ValueError``) counts as failed; any other
error (a kernel's, CUDA's) propagates.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from .metrics import (calculate_f1_score, calculate_precision,
                      calculate_recall, compute_metrics_for_threshold)


def _dataset_of(val_dataloader):
    """Accept either an ArrayDataLoader or a bare dataset."""
    return getattr(val_dataloader, "dataset", val_dataloader)


def collect_validation_results(
    analyzer,
    val_dataloader,
    threshold: float = 0.5,
    max_contracts: Optional[int] = None,
    generate_contracts: bool = True,
) -> Dict[str, Any]:
    """Sweep the validation set; collect aligned true/pred arrays.

    Line arrays are (num_types, max_length) line-slot-indexed, exactly like
    the dataset labels (notebook_utils.py:452-469 contract)."""
    dataset = _dataset_of(val_dataloader)
    ntypes = len(analyzer.vulnerability_types)
    max_len = analyzer.max_length

    results: Dict[str, Any] = {
        "contract_level": {"true_labels": [], "predicted_probs": [],
                           "predicted_labels": [], "source_codes": [],
                           "generated_codes": [], "contract_names": []},
        "line_level": {"true_labels": [], "predicted_probs": [],
                       "predicted_labels": [], "line_mappings": [],
                       "vulnerable_lines": []},
        "metadata": {"total_contracts": 0, "total_lines": 0,
                     "vulnerability_types": analyzer.vulnerability_types,
                     "processing_time": 0, "generation_success_rate": 0},
    }

    start = time.time()
    total = len(dataset.data)
    if max_contracts is not None:
        total = min(total, max_contracts)

    codes = [dataset.data[i]["source_code"] for i in range(total)]
    # batched detection
    detections = analyzer.analyze_multiple_contracts(codes,
                                                     threshold=threshold)

    successful_generations = 0
    for idx in range(total):
        data = dataset.data[idx]
        source_code = data["source_code"]
        true_contract = np.asarray(data["contract_vulnerabilities"])
        true_lines = np.asarray(data["vulnerable_lines"])     # (8, L)
        det = detections[idx]

        contract_probs = np.asarray(det["contract_probabilities"][0])
        contract_pred = (contract_probs > threshold).astype(np.int32)
        results["contract_level"]["true_labels"].append(true_contract)
        results["contract_level"]["predicted_probs"].append(contract_probs)
        results["contract_level"]["predicted_labels"].append(contract_pred)
        results["contract_level"]["source_codes"].append(source_code)
        results["contract_level"]["contract_names"].append(f"Contract_{idx}")

        # (L, 8) → (8, L) line-slot arrays padded to max_length
        lp = np.asarray(det["line_probabilities"][0])          # (L, 8)
        line_probs = np.zeros((ntypes, max_len), np.float32)
        n = min(lp.shape[0], max_len)
        line_probs[:, :n] = lp[:n].T
        line_pred = (line_probs > threshold).astype(np.int32)
        results["line_level"]["true_labels"].append(true_lines)
        results["line_level"]["predicted_probs"].append(line_probs)
        results["line_level"]["predicted_labels"].append(line_pred)
        results["line_level"]["line_mappings"].append(
            np.asarray(data.get("token_to_line", np.zeros(max_len, np.int32))))

        # vulnerable-line details (notebook_utils.py:640-705)
        lines = source_code.split("\n")
        vuln_lines = []
        for j, vt in enumerate(analyzer.vulnerability_types):
            for li in np.nonzero(true_lines[j])[0]:
                vuln_lines.append({
                    "line_number": int(li),
                    "vulnerability_type": vt,
                    "line_content": (lines[li] if li < len(lines) else ""),
                    "predicted": bool(line_pred[j, li]),
                    "probability": float(line_probs[j, li]),
                })
        results["line_level"]["vulnerable_lines"].append(vuln_lines)

        if generate_contracts:
            try:
                gen = analyzer.generate_synthetic_contract(
                    source_code, num_contracts=1, temperature=0.9)
                generated = gen[0] if gen else "Generation failed"
                if generated != "Generation failed":
                    successful_generations += 1
            except ValueError:
                generated = "Generation failed"
            results["contract_level"]["generated_codes"].append(generated)
        else:
            results["contract_level"]["generated_codes"].append(None)

        results["metadata"]["total_contracts"] += 1
        results["metadata"]["total_lines"] += len(lines)

    results["metadata"]["processing_time"] = time.time() - start
    tc = results["metadata"]["total_contracts"]
    results["metadata"]["generation_success_rate"] = (
        successful_generations / tc if tc else 0.0)
    return results


def compute_contract_level_metrics(validation_results: Dict[str, Any]
                                   ) -> Dict[str, Any]:
    """Overall + per-type contract metrics (notebook_utils.py:779-863)."""
    cl = validation_results["contract_level"]
    y_true = np.stack(cl["true_labels"])        # (N, 8)
    y_pred = np.stack(cl["predicted_labels"])
    y_probs = np.stack(cl["predicted_probs"])
    vuln_types = validation_results["metadata"]["vulnerability_types"]

    metrics: Dict[str, Any] = {
        "overall": compute_metrics_for_threshold(y_true, y_pred, y_probs),
        "per_vulnerability": {},
    }
    for j, vt in enumerate(vuln_types):
        metrics["per_vulnerability"][vt] = compute_metrics_for_threshold(
            y_true[:, j], y_pred[:, j], y_probs[:, j])
        metrics["per_vulnerability"][vt]["positives"] = int(y_true[:, j].sum())
    return metrics


def compute_line_level_metrics(validation_results: Dict[str, Any]
                               ) -> Dict[str, Any]:
    """Overall + per-type line metrics over *actual* lines only
    (notebook_utils.py:1134-1296): each contract contributes its true line
    count, not the padded 1024 slots."""
    ll = validation_results["line_level"]
    cl = validation_results["contract_level"]
    vuln_types = validation_results["metadata"]["vulnerability_types"]

    per_type_true: List[List[float]] = [[] for _ in vuln_types]
    per_type_pred: List[List[float]] = [[] for _ in vuln_types]
    per_type_probs: List[List[float]] = [[] for _ in vuln_types]
    for i, src in enumerate(cl["source_codes"]):
        n_lines = len(src.split("\n"))
        t = ll["true_labels"][i][:, :n_lines]
        p = ll["predicted_labels"][i][:, :n_lines]
        pr = ll["predicted_probs"][i][:, :n_lines]
        for j in range(len(vuln_types)):
            per_type_true[j].extend(t[j].tolist())
            per_type_pred[j].extend(p[j].tolist())
            per_type_probs[j].extend(pr[j].tolist())

    all_true = np.concatenate([np.asarray(x) for x in per_type_true])
    all_pred = np.concatenate([np.asarray(x) for x in per_type_pred])
    all_probs = np.concatenate([np.asarray(x) for x in per_type_probs])

    metrics: Dict[str, Any] = {
        "overall": compute_metrics_for_threshold(all_true, all_pred,
                                                 all_probs),
        "per_vulnerability": {},
        "statistics": {
            "total_line_slots": int(all_true.size),
            "true_vulnerable": int(all_true.sum()),
            "predicted_vulnerable": int(all_pred.sum()),
            "true_positives": int(np.sum((all_true > 0) & (all_pred > 0))),
        },
    }
    for j, vt in enumerate(vuln_types):
        t = np.asarray(per_type_true[j])
        p = np.asarray(per_type_pred[j])
        pr = np.asarray(per_type_probs[j])
        m = compute_metrics_for_threshold(t, p, pr)
        m["positives"] = int(t.sum())
        metrics["per_vulnerability"][vt] = m
    return metrics


def analyze_line_vulnerability_detection(validation_results: Dict[str, Any]
                                         ) -> Dict[str, Any]:
    """TP/FP/FN line analysis with examples (notebook_utils.py:1298-1443)."""
    ll = validation_results["line_level"]
    cl = validation_results["contract_level"]
    vuln_types = validation_results["metadata"]["vulnerability_types"]

    analysis: Dict[str, Any] = {
        "per_vulnerability": {vt: {"true_positives": 0, "false_positives": 0,
                                   "false_negatives": 0, "examples": []}
                              for vt in vuln_types},
        "totals": {"true_positives": 0, "false_positives": 0,
                   "false_negatives": 0},
    }
    for i, src in enumerate(cl["source_codes"]):
        lines = src.split("\n")
        n_lines = len(lines)
        t = ll["true_labels"][i][:, :n_lines]
        p = ll["predicted_labels"][i][:, :n_lines]
        for j, vt in enumerate(vuln_types):
            slot = analysis["per_vulnerability"][vt]
            tp_idx = np.nonzero((t[j] > 0) & (p[j] > 0))[0]
            fp_idx = np.nonzero((t[j] == 0) & (p[j] > 0))[0]
            fn_idx = np.nonzero((t[j] > 0) & (p[j] == 0))[0]
            slot["true_positives"] += len(tp_idx)
            slot["false_positives"] += len(fp_idx)
            slot["false_negatives"] += len(fn_idx)
            for li in tp_idx[:3]:
                slot["examples"].append({
                    "contract": i, "line": int(li), "kind": "TP",
                    "content": lines[li] if li < n_lines else ""})
    for vt in vuln_types:
        s = analysis["per_vulnerability"][vt]
        analysis["totals"]["true_positives"] += s["true_positives"]
        analysis["totals"]["false_positives"] += s["false_positives"]
        analysis["totals"]["false_negatives"] += s["false_negatives"]
        tp, fp, fn = (s["true_positives"], s["false_positives"],
                      s["false_negatives"])
        s["precision"] = tp / (tp + fp) if tp + fp else 0.0
        s["recall"] = tp / (tp + fn) if tp + fn else 0.0
        s["f1"] = calculate_f1_score(s["precision"], s["recall"])
    return analysis


def print_validation_summary(validation_results: Dict[str, Any]) -> None:
    """Console summary (notebook_utils.py:956-999)."""
    meta = validation_results["metadata"]
    print(f"Contracts processed: {meta['total_contracts']}")
    print(f"Total lines: {meta['total_lines']}")
    print(f"Processing time: {meta['processing_time']:.2f}s")
    print(f"Generation success rate: {meta['generation_success_rate']:.2%}")
    cm = compute_contract_level_metrics(validation_results)
    o = cm["overall"]
    print(f"Contract-level: acc={o['accuracy']:.4f} P={o['precision']:.4f} "
          f"R={o['recall']:.4f} F1={o['f1_score']:.4f} "
          f"PR-AUC={o['pr_auc']:.4f}")
    lm = compute_line_level_metrics(validation_results)
    o = lm["overall"]
    print(f"Line-level:     acc={o['accuracy']:.4f} P={o['precision']:.4f} "
          f"R={o['recall']:.4f} F1={o['f1_score']:.4f} "
          f"PR-AUC={o['pr_auc']:.4f}")
