"""Score a trained checkpoint of a CSV-mode run by the reference protocol.

Port of the JAX repo's ``tools/eval_checkpoint.py``: the eval tail of
``train_synthetic`` as a stage of its own, restartable without
retraining. The best checkpoint (or ``--ckpt``) through the per-type-
threshold comprehensive evaluation on the run's validation split, then
perplexity and ``summary.json`` (with the checkpoint's epoch and
validation loss from its sidecar).

    python -m sct_gan_tpu_torch.tools.eval_checkpoint --run /tmp/sct_run2k

``--d-model`` and ``--layers`` (defaults: the reference width) name the
run's width, as in ``train_synthetic``. It runs on the card; ``--device
cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

from ..utils import resolve_device
from ._common import (best_checkpoint, load_analyzer, model_config, score,
                      tokenizer_for, write_json)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", default="/tmp/sct_run2k")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-eval", type=int, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    from ..data.dataset import create_dataloaders
    from ..evals.perplexity import compute_perplexity
    ckpt = args.ckpt or best_checkpoint(os.path.join(args.run, "checkpoints"))
    print(f"evaluating checkpoint {ckpt}", flush=True)
    cfg = model_config(args.seq, args.d_model, args.layers)
    tok = tokenizer_for(cfg)
    t0 = time.time()
    _, val_loader = create_dataloaders(
        os.path.join(args.run, "corpus.csv"), tokenizer=tok,
        batch_size=args.batch_size, max_length=args.seq)
    print(f"val loader ready ({time.time() - t0:.0f}s)", flush=True)
    analyzer = load_analyzer(ckpt, cfg, tok, args.device, verbose=True)
    print(f"analyzer ready ({time.time() - t0:.0f}s)", flush=True)
    results = score(analyzer, ckpt, val_loader,
                    os.path.join(args.run, "evaluation_results.json"),
                    args.max_eval)
    print(f"eval done ({time.time() - t0:.0f}s)", flush=True)
    ppl = compute_perplexity(analyzer.model, val_loader)
    print(f"validation perplexity: {ppl['perplexity']:.2f} "
          f"(CE {ppl['cross_entropy']:.3f})", flush=True)

    summary = {
        "checkpoint": ckpt,
        "perplexity": ppl,
        "contract_overall": results["contract_level"]["overall"],
        "line_overall": results["line_level"]["overall"],
    }
    meta_path = ckpt + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        summary["epoch"] = meta.get("epoch")
        summary["best_val_loss"] = meta.get("val_loss")
    write_json(os.path.join(args.run, "summary.json"), summary)
    print(json.dumps(summary, indent=2, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
