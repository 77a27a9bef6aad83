"""Score a corpus-v2 checkpoint on a fresh in-family (family-0) test set.

Port of the JAX repo's ``tools/eval_v2_infamily.py``. Corpus-v2 trains on
template family 0 and reports the held-out families; this stage scores
the same checkpoint on new family-0 contracts (seed 2,000,000, with
distractors), the in-distribution counterpart of the reference's own
evaluation split, by the per-type-threshold protocol. It writes
``evaluation_infamily.json`` and ``summary_infamily.json`` into ``--run``.

    python -m sct_gan_tpu_torch.tools.eval_v2_infamily --run /tmp/sct_run_v2b

``--d-model`` and ``--layers`` (defaults: the reference width) name the
checkpoint's width. It runs on the card; ``--device cpu`` runs the plain
versions.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from ..utils import resolve_device
from ._common import (best_checkpoint, load_analyzer, model_config, score,
                      tokenizer_for, v2_loader, write_json)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", default="/tmp/sct_run_v2b")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=2_000_000)  # != train/val/test
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    ckpt = args.ckpt or best_checkpoint(os.path.join(args.run, "checkpoints"))
    print(f"checkpoint: {ckpt}", flush=True)
    cfg = model_config(args.seq, args.d_model, args.layers)
    tok = tokenizer_for(cfg)
    loader = v2_loader(tok, args.n, args.seed, 0, args.seq, args.batch_size)
    print(f"in-family test set: {args.n} family-0 contracts (seed "
          f"{args.seed})", flush=True)
    os.makedirs(args.run, exist_ok=True)
    analyzer = load_analyzer(ckpt, cfg, tok, args.device)
    results = score(analyzer, ckpt, loader,
                    os.path.join(args.run, "evaluation_infamily.json"))
    summary = {
        "checkpoint": ckpt,
        "n_contracts": args.n,
        "family": 0,
        "seed": args.seed,
        "contract_overall": results["contract_level"]["overall"],
        "line_overall": results["line_level"]["overall"],
    }
    write_json(os.path.join(args.run, "summary_infamily.json"), summary)
    print(json.dumps(summary, indent=2, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
