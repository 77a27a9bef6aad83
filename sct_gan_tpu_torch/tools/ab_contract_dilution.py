"""A/B: does padding dilution explain the contract head's ranking failure?

Port of the JAX repo's ``tools/ab_contract_dilution.py``. The contract
head mean-pools over all ``max_length`` positions, padding included
(SCT-GAN/model.py:462-466, a kept parity quirk). The reference's corpus
is filtered to 2048-token contracts, so at ``max_length=1024`` its pooled
feature sees almost no padding, while the synthetic corpus averaged ~170
tokens. This trains the same tiny recipe (``_common.quality_arm``: d=128,
4 heads, 2+2 layers, FFN 256, no GAN, no augmentation) through the port's
``SmartContractTrainer`` on one card, on a short corpus (~33% of a
512-token window) against a window-filling one (~95%, ``data/synthetic``'s
``target_tokens``), and prints each arm's contract PR-AUC and ROC-AUC on
the validation split, with the card's name and power limit, then one JSON
line. The model computes in f32 as the JAX tool's does; on the card its
head dim, 32, takes the f32 flash kernels' padded route to 64 (the JAX
tool turned flash attention off; the port has no such switch).

    python -m sct_gan_tpu_torch.tools.ab_contract_dilution
        [--contracts 300] [--epochs 30] [--seq 512]

``--device cpu`` runs it on the plain versions (small ``--contracts``,
``--epochs``, ``--seq`` and ``--vocab`` for a quick check).
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import List, Optional

from ..utils import resolve_device
from ._common import quality_args, quality_arm
from .bench import card_or_device, emit


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    quality_args(ap, "sct_ab_dilution")
    args = ap.parse_args(argv)
    card = card_or_device(resolve_device(args.device))
    from ..data.synthetic import write_corpus_csv
    work = args.work_dir or tempfile.mkdtemp(prefix="sct_ab_dilution_")
    try:
        os.makedirs(work, exist_ok=True)
        short_csv = os.path.join(work, "short.csv")
        long_csv = os.path.join(work, "long.csv")
        write_corpus_csv(short_csv, n=args.contracts, seed=0)
        write_corpus_csv(long_csv, n=args.contracts, seed=0,
                         target_tokens=(int(args.seq * 0.86),
                                        int(args.seq * 1.1)))
        arms = {}
        for name, path, title in (
                ("short", short_csv, "arm A: short contracts (~33% window "
                                     "fill)"),
                ("long", long_csv, "arm B: window-filling contracts (~95% "
                                   "fill)")):
            print(title, flush=True)
            arms[name] = quality_arm(
                name, path, args.seq, args.epochs, args.batch_size,
                args.device, card, work, args.vocab, use_gan=False,
                use_augmentation=False)
    finally:
        if not args.work_dir:
            shutil.rmtree(work, ignore_errors=True)
    a, b = arms["short"], arms["long"]
    print(f"RESULT short PR-AUC {a['pr_auc']:.3f} ROC {a['roc_auc']:.3f} | "
          f"long PR-AUC {b['pr_auc']:.3f} ROC {b['roc_auc']:.3f} [{card}]",
          flush=True)
    emit({"card": card, "contracts": args.contracts, "seq": args.seq,
          "batch_size": args.batch_size, "arms": arms}, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
