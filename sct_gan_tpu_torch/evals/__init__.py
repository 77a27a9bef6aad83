"""Evaluation: counterpart of ``sct_gan_tpu/evals``. Detection quality
(``validation``, ``harness``), scalar metrics in numpy (``metrics``),
teacher-forced perplexity (``perplexity``), the notebook helpers and the
training dashboard (``visualize``, matplotlib imported when it runs)."""
from .metrics import (calculate_f1_score, calculate_line_accuracy,
                      calculate_precision, calculate_recall,
                      compute_metrics_for_threshold, get_vulnerability_index)
from .validation import (analyze_line_vulnerability_detection,
                         collect_validation_results,
                         compute_contract_level_metrics,
                         compute_line_level_metrics, print_validation_summary)
from .harness import (BASELINE_CONTRACT_THRESHOLDS, BASELINE_LINE_THRESHOLDS,
                      evaluate_model_performance, print_evaluation_summary)
from .visualize import visualize_training_progress

__all__ = [
    "calculate_precision",
    "calculate_recall",
    "calculate_f1_score",
    "calculate_line_accuracy",
    "get_vulnerability_index",
    "compute_metrics_for_threshold",
    "collect_validation_results",
    "compute_contract_level_metrics",
    "compute_line_level_metrics",
    "analyze_line_vulnerability_detection",
    "print_validation_summary",
    "evaluate_model_performance",
    "print_evaluation_summary",
    "BASELINE_CONTRACT_THRESHOLDS",
    "BASELINE_LINE_THRESHOLDS",
    "visualize_training_progress",
]
from .perplexity import compute_perplexity

__all__ += ["compute_perplexity"]
