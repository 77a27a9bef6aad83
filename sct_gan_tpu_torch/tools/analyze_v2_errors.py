"""Per-type error analysis of a trained checkpoint on a corpus-v2 family.

Port of the JAX repo's ``tools/analyze_v2_errors.py``: the reference's
TP/FP/FN line analysis (``evals.validation.
analyze_line_vulnerability_detection``) and, per type, the contract-level
score separations (mean and quartiles of the predicted probability on
positives and on negatives, the share of negatives above the positive
median) and the confusion drivers (among high-scoring negatives of a type,
which types they do have): why a contract-level PR-AUC is low when the
line head is right.

    python -m sct_gan_tpu_torch.tools.analyze_v2_errors \\
        --ckpt /tmp/sct_run_v2b/checkpoints/best_model_augmented_gan_epoch_N \\
        --family 2 --out errors_fam2.json

It runs on the card; ``--device cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np

from ..utils import resolve_device
from ._common import (load_analyzer, model_config, tokenizer_for, v2_loader,
                      write_json)


def contract_separation(y_true: np.ndarray, y_prob: np.ndarray,
                        vts: List[str]) -> Dict:
    """Per type with a positive: how far the positives' scores sit above
    the negatives' (>0.5 ``neg_above_pos_median``: the ranking is
    effectively inverted)."""
    out = {}
    for j, vt in enumerate(vts):
        pos, neg = y_prob[y_true[:, j], j], y_prob[~y_true[:, j], j]
        if not len(pos):
            continue
        out[vt] = {
            "n_pos": int(len(pos)),
            "pos_prob_mean": float(pos.mean()),
            "pos_prob_q25_50_75": [float(q) for q in
                                   np.percentile(pos, [25, 50, 75])],
            "neg_prob_mean": float(neg.mean()),
            "neg_prob_q25_50_75": [float(q) for q in
                                   np.percentile(neg, [25, 50, 75])],
            "neg_above_pos_median": float(
                (neg > np.median(pos)).mean()) if len(neg) else 0.0,
        }
    return out


def confusion_drivers(y_true: np.ndarray, y_prob: np.ndarray,
                      vts: List[str]) -> Dict:
    """For each type j with at least 10 negatives: among the contracts
    without j that score in j's top decile, the count of each type they do
    have."""
    out = {}
    for j, vt in enumerate(vts):
        neg_mask = ~y_true[:, j]
        if neg_mask.sum() < 10:
            continue
        thr = np.percentile(y_prob[:, j], 90)
        hot = neg_mask & (y_prob[:, j] >= thr)
        if not hot.sum():
            continue
        co = {vts[k]: int(y_true[hot, k].sum()) for k in range(len(vts))
              if k != j and y_true[hot, k].sum()}
        out[vt] = {"high_scoring_negatives": int(hot.sum()),
                   "their_actual_types": co}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--family", type=int, default=1)
    ap.add_argument("--contracts", type=int, default=200)
    ap.add_argument("--seed", type=int, default=None,
                    help="corpus seed (default: 10**6 + family, the "
                         "train_synthetic test-column seed)")
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    from ..evals.validation import (analyze_line_vulnerability_detection,
                                    collect_validation_results)
    cfg = model_config(args.seq, args.d_model, args.layers)
    tok = tokenizer_for(cfg)
    seed = args.seed if args.seed is not None else 10 ** 6 + args.family
    loader = v2_loader(tok, args.contracts, seed, args.family, args.seq, 8)
    analyzer = load_analyzer(args.ckpt, cfg, tok, args.device)
    results = collect_validation_results(analyzer, loader, threshold=0.4,
                                         generate_contracts=False)
    line_analysis = analyze_line_vulnerability_detection(results)

    cl = results["contract_level"]
    y_true = np.stack(cl["true_labels"]).astype(bool)      # (N, 8)
    y_prob = np.stack(cl["predicted_probs"])               # (N, 8)
    vts = results["metadata"]["vulnerability_types"]
    out = {
        "checkpoint": args.ckpt,
        "family": args.family,
        "contracts": args.contracts,
        "contract_score_separation": contract_separation(y_true, y_prob, vts),
        "contract_confusion_drivers": confusion_drivers(y_true, y_prob, vts),
        "line_tp_fp_fn": {
            vt: {k: v for k, v in d.items() if k != "examples"}
            for vt, d in line_analysis["per_vulnerability"].items()},
        "line_totals": line_analysis["totals"],
    }
    print(json.dumps(out, indent=2, default=float))
    if args.out:
        write_json(args.out, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
