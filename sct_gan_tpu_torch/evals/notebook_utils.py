"""Notebook-facing helpers — import-swap parity with
`SCT-GAN/notebook_utils.py`; counterpart of
``sct_gan_tpu/evals/notebook_utils.py``.

The heavyweight sweeps/metrics live in evals/validation.py and
evals/harness.py; this module adds the per-contract analysis and diagnostic
helpers (notebook_utils.py:109-428, 1494-1874, 2025-2110) and re-exports
everything under the reference's flat-module layout, so reference notebooks
need only swap `import notebook_utils` for
`from sct_gan_tpu_torch.evals import notebook_utils`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .metrics import (calculate_f1_score, calculate_line_accuracy,
                      calculate_precision, calculate_recall,
                      compute_metrics_for_threshold, get_vulnerability_index)
from .validation import (analyze_line_vulnerability_detection,
                         collect_validation_results,
                         compute_contract_level_metrics,
                         compute_line_level_metrics, print_validation_summary)
from .visualize import visualize_training_progress

__all__ = [
    "calculate_precision", "calculate_recall", "calculate_f1_score",
    "calculate_line_accuracy", "get_vulnerability_index",
    "compute_metrics_for_threshold", "collect_validation_results",
    "compute_contract_level_metrics", "compute_line_level_metrics",
    "analyze_line_vulnerability_detection", "print_validation_summary",
    "visualize_training_progress", "get_vulnerability_details",
    "generate_syntax_aware_contract", "analyze_contract_with_syntax_generation",
    "print_analysis_summary", "debug_line_predictions",
    "check_model_line_predictions", "diagnose_line_detection_issues",
    "debug_model_issues", "collect_validation_results_simple",
    "analyze_vulnerable_contracts", "analyze_vulnerable_line_probabilities",
    "print_probability_analysis", "print_line_vulnerability_summary",
    "print_simplified_validation_summary",
]


def get_vulnerability_details(analyzer, true_contract_vulns: np.ndarray,
                              pred_contract_array: np.ndarray,
                              pred_contract_probs: List[float]
                              ) -> Dict[str, Any]:
    """Per-type correctness / high-confidence / misclassification report
    (notebook_utils.py:109-162)."""
    details: Dict[str, Any] = {"vulnerability_analysis": {},
                               "high_confidence_predictions": [],
                               "misclassifications": []}
    for i, vuln_type in enumerate(analyzer.vulnerability_types):
        true_label = bool(true_contract_vulns[i])
        pred_label = bool(pred_contract_array[i])
        confidence = float(pred_contract_probs[i])
        details["vulnerability_analysis"][vuln_type] = {
            "true_label": true_label, "predicted_label": pred_label,
            "confidence": confidence, "correct": true_label == pred_label}
        if confidence > 0.8:
            details["high_confidence_predictions"].append(
                {"vulnerability": vuln_type, "predicted": pred_label,
                 "confidence": confidence})
        if true_label != pred_label:
            details["misclassifications"].append(
                {"vulnerability": vuln_type, "true_label": true_label,
                 "predicted_label": pred_label, "confidence": confidence})
    return details


def generate_syntax_aware_contract(analyzer, contract_template: str,
                                   num_contracts: int = 1,
                                   temperature: float = 0.9,
                                   max_length: int = 1024) -> List[str]:
    """Syntax-aware generation with template fallback
    (notebook_utils.py:164-223). The fallback takes only the port's
    refusal of bad input (``ValueError``); a kernel's or CUDA's error
    propagates."""
    try:
        return analyzer.generate_synthetic_contract(
            contract_template=contract_template, num_contracts=num_contracts,
            temperature=temperature, max_length=max_length)
    except ValueError:
        out = []
        for _ in range(num_contracts):
            try:
                out.append(analyzer.generate_template_based_contract(
                    contract_template))
            except ValueError:
                out.append("// Generation failed - using template\n"
                           + contract_template)
        return out


def analyze_contract_with_syntax_generation(
    analyzer, source_code: str, true_contract_vulns: np.ndarray,
    true_line_vulns: np.ndarray, threshold: float = 0.5,
    generate: bool = True,
) -> Dict[str, Any]:
    """Single-contract full analysis: detection + details + line accuracy +
    optional generation (notebook_utils.py:225-361)."""
    det = analyzer.detect_vulnerabilities(source_code, threshold=threshold)
    pred_probs = np.asarray(det["contract_probabilities"][0])
    pred_array = (pred_probs > threshold).astype(np.int32)
    results = {
        "source_code": source_code,
        "detection": det,
        "vulnerability_details": get_vulnerability_details(
            analyzer, np.asarray(true_contract_vulns), pred_array,
            pred_probs.tolist()),
        "line_accuracy": calculate_line_accuracy(
            np.asarray(true_line_vulns), det["line_vulnerabilities"]),
        "generated_contract": None,
    }
    if generate:
        gen = generate_syntax_aware_contract(analyzer, source_code,
                                             num_contracts=1,
                                             temperature=0.9)
        results["generated_contract"] = gen[0] if gen else None
    return results


def print_analysis_summary(results: Dict[str, Any]) -> None:
    """Pretty-printer for `analyze_contract_with_syntax_generation`
    (notebook_utils.py:363-428)."""
    va = results["vulnerability_details"]["vulnerability_analysis"]
    print("=" * 60)
    print("CONTRACT ANALYSIS SUMMARY")
    print("=" * 60)
    for vuln_type, d in va.items():
        status = "✓" if d["correct"] else "✗"
        print(f"{status} {vuln_type:>10}: true={d['true_label']} "
              f"pred={d['predicted_label']} conf={d['confidence']:.3f}")
    print(f"Line accuracy: {results['line_accuracy']:.4f}")
    mis = results["vulnerability_details"]["misclassifications"]
    if mis:
        print(f"Misclassifications: {[m['vulnerability'] for m in mis]}")
    if results.get("generated_contract"):
        print(f"Generated contract: "
              f"{len(results['generated_contract'])} characters")


def collect_validation_results_simple(analyzer, val_dataloader,
                                      threshold: float = 0.5,
                                      max_contracts: Optional[int] = None
                                      ) -> Dict[str, Any]:
    """Contract-only sweep, no generation (notebook_utils.py:1001-1132)."""
    return collect_validation_results(analyzer, val_dataloader,
                                      threshold=threshold,
                                      max_contracts=max_contracts,
                                      generate_contracts=False)


# -- diagnostics -----------------------------------------------------------

def debug_line_predictions(validation_results: Dict[str, Any],
                           contract_idx: int = 0) -> None:
    """Per-contract line-prediction dump (notebook_utils.py:1494-1571)."""
    ll = validation_results["line_level"]
    probs = np.asarray(ll["predicted_probs"][contract_idx])
    true = np.asarray(ll["true_labels"][contract_idx])
    print(f"Contract {contract_idx}: prob range "
          f"[{probs.min():.4f}, {probs.max():.4f}], "
          f"mean {probs.mean():.4f}")
    print(f"True vulnerable slots: {int(true.sum())}")
    for j, vt in enumerate(
            validation_results["metadata"]["vulnerability_types"]):
        if true[j].sum() > 0:
            idx = np.nonzero(true[j])[0]
            print(f"  {vt}: lines {idx.tolist()} "
                  f"probs {[round(float(probs[j, i]), 3) for i in idx]}")


def check_model_line_predictions(analyzer, sample_contract: str) -> None:
    """Quick live check of line outputs (notebook_utils.py:1716-1771)."""
    res = analyzer.detect_vulnerabilities(sample_contract, threshold=0.5)
    lp = np.asarray(res["line_probabilities"][0])
    print(f"Line prob stats: min {lp.min():.4f} max {lp.max():.4f} "
          f"mean {lp.mean():.4f} std {lp.std():.4f}")
    n_pred = sum(1 for line in res["line_vulnerabilities"].values()
                 if any(line.values()))
    print(f"Lines with any predicted vulnerability: {n_pred}")


def diagnose_line_detection_issues(validation_results: Dict[str, Any]
                                   ) -> None:
    """Aggregate line-head health report (notebook_utils.py:1773-1874)."""
    ll = validation_results["line_level"]
    probs = np.stack([np.asarray(p) for p in ll["predicted_probs"]])
    true = np.stack([np.asarray(t) for t in ll["true_labels"]])
    print(f"Probability distribution: mean {probs.mean():.4f} "
          f"std {probs.std():.4f}")
    if probs.std() < 1e-4:
        print("🚨 Line head collapse: all probabilities identical")
    pos = probs[true > 0]
    neg = probs[true == 0]
    if pos.size:
        print(f"Mean prob on true-vulnerable: {pos.mean():.4f}")
    print(f"Mean prob on non-vulnerable: {neg.mean():.4f}")
    if pos.size and pos.mean() <= neg.mean():
        print("⚠️  No separation between vulnerable and clean lines")


def debug_model_issues(analyzer, sample_contract: Optional[str] = None
                       ) -> Dict[str, Any]:
    """Model debug report (notebook_utils.py:2025-2110)."""
    diagnostics: Dict[str, Any] = {}
    diagnostics["functionality"] = analyzer.test_model_functionality()
    diagnostics["generation"] = analyzer.diagnose_generation_model()
    if sample_contract:
        res = analyzer.detect_vulnerabilities(sample_contract)
        cp = np.asarray(res["contract_probabilities"][0])
        diagnostics["sample_contract_probs"] = cp.tolist()
        diagnostics["sample_all_high"] = bool((cp > 0.9).all())
        diagnostics["sample_all_low"] = bool((cp < 0.1).all())
    return diagnostics


def analyze_vulnerable_contracts(validation_results: Dict[str, Any],
                                 metrics: Optional[Dict[str, Any]] = None,
                                 top_k: int = 10) -> Dict[str, Any]:
    """Top-k most-vulnerable contracts + generation-quality report
    (notebook_utils.py:865-954). Vulnerability score = sum of predicted
    per-type probabilities."""
    cl = validation_results["contract_level"]
    contract_true = np.stack(cl["true_labels"])
    contract_probs = np.stack(cl["predicted_probs"])
    scores = contract_probs.sum(axis=1)
    top_idx = np.argsort(scores)[-top_k:][::-1]
    vuln_types = validation_results["metadata"]["vulnerability_types"]

    analysis: Dict[str, Any] = {
        "top_vulnerable_contracts": [],
        "vulnerability_distribution": {vt: int(contract_true[:, j].sum())
                                       for j, vt in enumerate(vuln_types)},
        "generation_quality": {"successful_generations": 0,
                               "failed_generations": 0,
                               "avg_generated_length": 0.0},
    }
    lengths = []
    for rank, idx in enumerate(top_idx, 1):
        generated = cl["generated_codes"][idx]
        ok = generated is not None and generated != "Generation failed"
        if ok:
            analysis["generation_quality"]["successful_generations"] += 1
            lengths.append(len(generated))
        else:
            analysis["generation_quality"]["failed_generations"] += 1
        analysis["top_vulnerable_contracts"].append({
            "rank": rank,
            "contract_name": cl["contract_names"][idx],
            "vulnerability_score": float(scores[idx]),
            "true_vulnerabilities": [vt for j, vt in enumerate(vuln_types)
                                     if contract_true[idx, j]],
            "predicted_probabilities": {
                vt: float(contract_probs[idx, j])
                for j, vt in enumerate(vuln_types)},
            "generation_success": ok,
        })
    if lengths:
        analysis["generation_quality"]["avg_generated_length"] = (
            sum(lengths) / len(lengths))
    return analysis


def analyze_vulnerable_line_probabilities(
        validation_results: Dict[str, Any]) -> Dict[str, Any]:
    """Probability statistics over true-vulnerable lines
    (notebook_utils.py:1573-1675): per-type and overall means plus a
    high/medium/low confidence histogram."""
    ll = validation_results.get("line_level")
    if not ll:
        return {}
    vuln_types = validation_results["metadata"]["vulnerability_types"]
    true = np.stack([np.asarray(t) for t in ll["true_labels"]])
    probs = np.stack([np.asarray(p) for p in ll["predicted_probs"]])

    analysis: Dict[str, Any] = {
        "per_vulnerability_type": {},
        "overall_stats": {
            "total_vulnerable_lines": int((true > 0).sum()),
            "mean_probability_vulnerable_lines": 0.0,
            "mean_probability_all_lines": float(probs.mean()),
            "probability_distribution": {"high_confidence": 0,
                                         "medium_confidence": 0,
                                         "low_confidence": 0},
        },
    }
    vuln_probs_all = probs[true > 0]
    if vuln_probs_all.size:
        analysis["overall_stats"]["mean_probability_vulnerable_lines"] = (
            float(vuln_probs_all.mean()))
        dist = analysis["overall_stats"]["probability_distribution"]
        dist["high_confidence"] = int((vuln_probs_all > 0.8).sum())
        dist["medium_confidence"] = int(
            ((vuln_probs_all > 0.5) & (vuln_probs_all <= 0.8)).sum())
        dist["low_confidence"] = int((vuln_probs_all <= 0.5).sum())
    for j, vt in enumerate(vuln_types):
        sel = probs[:, j][true[:, j] > 0]
        analysis["per_vulnerability_type"][vt] = {
            "vulnerable_lines": int((true[:, j] > 0).sum()),
            "mean_probability": float(sel.mean()) if sel.size else 0.0,
            "max_probability": float(sel.max()) if sel.size else 0.0,
        }
    return analysis


def print_probability_analysis(analysis: Dict[str, Any]) -> None:
    """Printer for analyze_vulnerable_line_probabilities
    (notebook_utils.py:1677-1714)."""
    o = analysis.get("overall_stats", {})
    print(f"Vulnerable lines: {o.get('total_vulnerable_lines', 0)}")
    print(f"Mean prob (vulnerable): "
          f"{o.get('mean_probability_vulnerable_lines', 0.0):.4f}")
    print(f"Mean prob (all):        "
          f"{o.get('mean_probability_all_lines', 0.0):.4f}")
    d = o.get("probability_distribution", {})
    print(f"Confidence: high {d.get('high_confidence', 0)}, "
          f"medium {d.get('medium_confidence', 0)}, "
          f"low {d.get('low_confidence', 0)}")
    for vt, s in analysis.get("per_vulnerability_type", {}).items():
        if s["vulnerable_lines"]:
            print(f"  {vt:>10}: {s['vulnerable_lines']:4d} lines, "
                  f"mean {s['mean_probability']:.4f}, "
                  f"max {s['max_probability']:.4f}")


def print_line_vulnerability_summary(analysis: Dict[str, Any]) -> None:
    """Printer for analyze_line_vulnerability_detection
    (notebook_utils.py:1445-1492)."""
    t = analysis["totals"]
    print(f"TP {t['true_positives']}  FP {t['false_positives']}  "
          f"FN {t['false_negatives']}")
    for vt, s in analysis["per_vulnerability"].items():
        if s["true_positives"] + s["false_positives"] + s["false_negatives"]:
            print(f"  {vt:>10}: P={s['precision']:.3f} R={s['recall']:.3f} "
                  f"F1={s['f1']:.3f} (TP {s['true_positives']} "
                  f"FP {s['false_positives']} FN {s['false_negatives']})")


def print_simplified_validation_summary(validation_results: Dict[str, Any]
                                        ) -> None:
    """Contract-only summary printer (notebook_utils.py:744-777)."""
    meta = validation_results["metadata"]
    print(f"Contracts: {meta['total_contracts']}, "
          f"lines: {meta['total_lines']}, "
          f"time: {meta['processing_time']:.2f}s")
    cm = compute_contract_level_metrics(validation_results)
    o = cm["overall"]
    print(f"Contract metrics: acc={o['accuracy']:.4f} "
          f"P={o['precision']:.4f} R={o['recall']:.4f} "
          f"F1={o['f1_score']:.4f}")
