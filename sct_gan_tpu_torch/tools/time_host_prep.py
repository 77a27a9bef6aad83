"""The trainer's host preparation per epoch: augmentation and
tokenization.

Port of the JAX repo's ``tools/time_host_prep.py``. The reference re-runs
its regex transforms and re-tokenizes every contract every epoch
(SCT-GAN/train.py:774-866); this times only that host path, the trainer's
``_create_augmented_batch`` and ``_pad_to_dp`` over whole epochs of the
training loader, with the augmentation bank (``aug_bank_size`` 6: each
contract's variants tokenized once, then sampled) and without it (0: the
reference's re-tokenization every epoch). No device work is in the loop:
the trainer's model is a tiny one (d=32, 1+1 layers, f32 as the JAX
tool's; its attention runs the f32 flash kernel on the card) that runs only the trainer's
start-up forward (``_dimension_smoke_test``), and it sits on ``--device``
like every other entry point's. The JSON gives each bank's kernel
launches over its epochs (none).

The corpus is ``data/synthetic.py``'s (``write_corpus_csv``, seed 0) of
``--contracts`` contracts, read by ``create_dataloaders`` with the port's
``NativeSolidityTokenizer`` (the C++ encode path where it builds). Each
epoch's seconds are the host clock's.

    python -m sct_gan_tpu_torch.tools.time_host_prep [--contracts 500]
        [--epochs 3]

``--corpus-dir`` is the directory the corpus is written to (the JAX
tool's ``--out``; a temporary one, removed after, by default). Prints the
JAX tool's lines, each with the card's name and power limit, then one JSON
line (``--out``: also written to that file, as every port tool's).
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

from ..utils import resolve_device
from .bench import _since, card_or_device, emit, kernel_launches

BANKS = (6, 0)


def prep_config(seq: int):
    """The tiny GAN model of ``time_host_prep.py:58-62``, f32 as the JAX
    tool's (which also turns flash attention off; the port has no such
    switch, so on the card it runs the f32 flash kernels)."""
    from ..config import ModelConfig
    return ModelConfig(d_model=32, nhead=2, num_encoder_layers=1,
                       num_decoder_layers=1, dim_feedforward=64,
                       max_length=seq, max_lines=seq, use_gan=True,
                       compute_dtype="float32")


def prep_trainer(train_loader, val_loader, tok, seq: int, bank: int,
                 device: str):
    """The trainer of ``time_host_prep.py:58-70``: augmentation on, the
    bank of ``bank`` variants a contract, the tiny model."""
    from ..config import TrainConfig
    from ..models.sct_transformer import SmartContractTransformer
    from ..train.trainer import SmartContractTrainer
    return SmartContractTrainer(
        SmartContractTransformer(prep_config(seq), seed=0), train_loader,
        val_loader, tok,
        config=TrainConfig(use_gan=True, use_augmentation=True,
                           aug_bank_size=bank),
        device=device, verbose=False)


def prepare(trainer, batch: Dict) -> Dict:
    """One batch's host preparation, as the training step's caller runs
    it."""
    return trainer._pad_to_dp(trainer._create_augmented_batch(batch))


def time_epochs(trainer, loader, epochs: int) -> List[Dict[str, float]]:
    """Each epoch's host seconds and batches over ``loader``, in order."""
    out = []
    for _ in range(epochs):
        t0 = time.perf_counter()
        nb = 0
        for batch in loader:
            prepare(trainer, batch)
            nb += 1
        dt = time.perf_counter() - t0
        out.append({"seconds": dt, "batches": nb,
                    "ms_per_batch": dt / max(nb, 1) * 1e3})
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--contracts", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--corpus-dir", default="",
                    help="the corpus's directory (default: a temporary one)")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_or_device(device)
    from ..data.dataset import create_dataloaders
    from ..data.native_tokenizer import NativeSolidityTokenizer
    from ..data.synthetic import write_corpus_csv

    out_dir = args.corpus_dir or tempfile.mkdtemp(prefix="sct_hostprep_")
    try:
        os.makedirs(out_dir, exist_ok=True)
        csv_path = os.path.join(out_dir, "corpus.csv")
        write_corpus_csv(csv_path, n=args.contracts, seed=0)
        tok = NativeSolidityTokenizer()
        print(f"native tokenizer: {tok.native_active}", flush=True)
        t0 = time.perf_counter()
        train_loader, val_loader = create_dataloaders(
            csv_path, tokenizer=tok, batch_size=args.batch_size,
            max_length=args.seq)
        build_s = time.perf_counter() - t0
        n_train = len(train_loader.dataset)
        print(f"dataset build: {build_s:.1f}s ({n_train} train contracts) "
              f"[{card}]", flush=True)
        res: Dict[str, object] = {
            "card": card, "contracts": args.contracts,
            "train_contracts": n_train, "batch_size": args.batch_size,
            "seq": args.seq, "native_tokenizer": tok.native_active,
            "dataset_build_s": build_s, "timing": "host clock", "banks": {}}
        for bank in BANKS:
            trainer = prep_trainer(train_loader, val_loader, tok, args.seq,
                                   bank, str(device))
            label = f"aug_bank_size={bank}"
            before = kernel_launches()
            epochs = time_epochs(trainer, train_loader, args.epochs)
            launches = _since(before)
            for i, e in enumerate(epochs):
                print(f"{label}: epoch {i}: {e['seconds']:.2f}s "
                      f"host prep ({e['batches']} batches, "
                      f"{e['ms_per_batch']:.0f} ms/batch) [{card}]",
                      flush=True)
            res["banks"][label] = {"epochs": epochs, "launches": launches}
    finally:
        if not args.corpus_dir:
            shutil.rmtree(out_dir, ignore_errors=True)
    emit(res, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
