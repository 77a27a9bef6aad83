"""A/B: does the reference's augmented-batch label-by-index quirk starve the
contract head?

Port of the JAX repo's ``tools/ab_aug_labels.py``. The reference's
``_create_augmented_batch`` samples its (original, variant) pairs from a
pool across all contracts of the batch, then gives pair i the labels of
batch slot i (SCT-GAN/train.py:829-839), so about (B-1)/B of the augmented
examples carry another contract's labels. This trains the same tiny
recipe (``_common.quality_arm``: d=128, 4 heads, 2+2 layers, FFN 256, the
GAN on, augmentation on) through the port's ``SmartContractTrainer`` on
one card under (a) the quirk (``aug_label_correct=False``) and (b) the
source's own labels, and prints each arm's contract PR-AUC and ROC-AUC on
the validation split, with the card's name and power limit, then one JSON
line. The model computes in f32 as the JAX tool's does; on the card its
head dim, 32, takes the f32 flash kernels' padded route to 64 (the JAX
tool turned flash attention off; the port has no such switch).

    python -m sct_gan_tpu_torch.tools.ab_aug_labels [--contracts 300]
        [--epochs 30] [--seq 512]

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
    quality_args(ap, "sct_ab_auglabels")
    args = ap.parse_args(argv)
    card = card_or_device(resolve_device(args.device))
    from ..data.synthetic import write_corpus_csv
    work = args.work_dir or tempfile.mkdtemp(prefix="sct_ab_auglabels_")
    try:
        os.makedirs(work, exist_ok=True)
        csv_path = os.path.join(work, "corpus.csv")
        write_corpus_csv(csv_path, n=args.contracts, seed=0)
        arms = {}
        for name, correct, title in (
                ("quirk", False, "arm A: reference label-by-index quirk "
                                 "(aug_label_correct=False)"),
                ("correct", True, "arm B: source-correct labels "
                                  "(aug_label_correct=True)")):
            print(title, flush=True)
            arms[name] = quality_arm(
                name, csv_path, args.seq, args.epochs, args.batch_size,
                args.device, card, work, args.vocab, use_gan=True,
                use_augmentation=True, aug_label_correct=correct)
    finally:
        if not args.work_dir:
            shutil.rmtree(work, ignore_errors=True)
    a, b = arms["quirk"], arms["correct"]
    print(f"RESULT quirk PR-AUC {a['pr_auc']:.3f} ROC {a['roc_auc']:.3f} | "
          f"correct PR-AUC {b['pr_auc']:.3f} ROC {b['roc_auc']:.3f} "
          f"[{card}]", flush=True)
    emit({"card": card, "contracts": args.contracts, "seq": args.seq,
          "batch_size": args.batch_size, "arms": arms}, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
