"""Train a full-size checkpoint on the synthetic corpus and score it by the
reference's evaluation protocol.

Port of the JAX repo's ``tools/train_synthetic.py``: the same flags and
defaults (plus ``--device``), the same corpora and seeds, the same
``TrainConfig``, then the best checkpoint through the per-type-threshold
comprehensive evaluation (one column per template family in corpus-v2
mode), teacher-forced perplexity and ``summary.json`` with the JAX tool's
keys. The three parts are ``build_run`` (configuration, tokenizer,
loaders), ``build_trainer`` and ``evaluate_run`` (the eval tail).
Per-epoch wall times go to ``timing.json`` beside the summary.

    python -m sct_gan_tpu_torch.tools.train_synthetic --corpus-v2 \\
        --contracts 2000 --train-family 0 --model-select detection \\
        --epochs 150 --out /tmp/sct_run_v2b

It runs on the card; ``--device cpu`` runs the plain versions (small
sizes only).
"""
from __future__ import annotations

import argparse
import gc
import os
import time
from typing import Dict, List, NamedTuple, Optional

from ..utils import resolve_device
from ._common import (best_checkpoint, load_analyzer, matrix_column,
                      model_config, score, tokenizer_for, v2_loader,
                      write_json)

# corpus-v2 seeds of the JAX tool (tools/train_synthetic.py:91-107): train
# 0, validation 777, the test column of family f 10**6 + f
TRAIN_SEED, VAL_SEED, TEST_SEED = 0, 777, 10 ** 6


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--contracts", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--out", default="/tmp/sct_run")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--d-model", type=int, default=768,
                    help="shrink for smoke runs (full-size parity: 768)")
    ap.add_argument("--layers", type=int, default=6,
                    help="encoder/decoder layer count (parity: 6)")
    ap.add_argument("--no-aug", action="store_true")
    ap.add_argument("--max-eval", type=int, default=None)
    ap.add_argument("--corpus-v2", action="store_true",
                    help="train on ONE template family (+ near-miss "
                         "distractors), validate in-family, evaluate on "
                         "every disjoint family")
    ap.add_argument("--train-family", type=int, default=0,
                    help="corpus-v2 training family (0 or 1; family 2 is "
                         "the never-trained matrix column)")
    ap.add_argument("--eval-contracts", type=int, default=None,
                    help="held-out per-family corpus size (corpus-v2 only; "
                         "default contracts//5, at least 20)")
    ap.add_argument("--patience", type=int, default=None,
                    help="early-stop patience override (default: reference "
                         "parity, 24)")
    ap.add_argument("--model-select", default="gen_loss",
                    choices=["gen_loss", "detection"],
                    help="validation signal for best-checkpoint/early-stop/"
                         "plateau (TrainConfig.model_select)")
    ap.add_argument("--max-minutes", type=float, default=None,
                    help="the port's: end training after the last epoch "
                         "that the mean epoch so far says fits in this "
                         "many minutes (a prefix of the --epochs run)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


class Run(NamedTuple):
    """What a run trains and is scored on."""
    cfg: object
    tok: object
    train_loader: object
    val_loader: object
    test_loaders: Dict[str, object]     # corpus-v2 only: "fam<f>" -> loader


def build_run(args: argparse.Namespace) -> Run:
    """The model configuration, the tokenizer and the loaders. Corpus-v2:
    train and validation on the training family (with distractors), one
    test loader per family from fresh seeds. Otherwise the CSV corpus of
    ``--contracts`` contracts written to ``<out>/corpus.csv`` and split as
    the reference splits it."""
    os.makedirs(args.out, exist_ok=True)
    cfg = model_config(args.seq, args.d_model, args.layers)
    tok = tokenizer_for(cfg)
    print(f"native tokenizer: {tok.native_active}", flush=True)
    test_loaders = {}
    if args.corpus_v2:
        from ..data.synthetic import _FAMILIES
        fam = args.train_family
        n_eval = args.eval_contracts or max(args.contracts // 5, 20)
        n_val = max(args.contracts // 10, 16)
        # model selection uses an in-family validation split; the family
        # test columns are never seen in training
        train_loader = v2_loader(tok, args.contracts, TRAIN_SEED, fam,
                                 args.seq, args.batch_size, shuffle=True)
        val_loader = v2_loader(tok, n_val, VAL_SEED, fam, args.seq,
                               args.batch_size)
        for f in sorted(_FAMILIES):
            test_loaders[f"fam{f}"] = v2_loader(
                tok, n_eval, TEST_SEED + f, f, args.seq, args.batch_size)
        print(f"corpus v2: {args.contracts} train + {n_val} val (family "
              f"{fam} + distractors), {n_eval}-contract TEST per family "
              f"{sorted(_FAMILIES)}", flush=True)
    else:
        from ..data.dataset import create_dataloaders
        from ..data.synthetic import write_corpus_csv
        csv_path = os.path.join(args.out, "corpus.csv")
        write_corpus_csv(csv_path, n=args.contracts, seed=0)
        print(f"corpus: {args.contracts} contracts -> {csv_path}", flush=True)
        train_loader, val_loader = create_dataloaders(
            csv_path, tokenizer=tok, batch_size=args.batch_size,
            max_length=args.seq)
    return Run(cfg, tok, train_loader, val_loader, test_loaders)


def build_trainer(args: argparse.Namespace, run: Run):
    """The trainer with the JAX tool's ``TrainConfig`` on one device
    (``mesh=None``, which the 1 x 1 mesh equals bit for bit)."""
    from ..config import TrainConfig
    from ..models.sct_transformer import SmartContractTransformer
    from ..train.trainer import SmartContractTrainer
    tcfg = TrainConfig(learning_rate=args.lr, use_gan=True,
                       use_augmentation=not args.no_aug,
                       warmup_epochs=5, line_lr_max=5e-4,
                       model_select=args.model_select,
                       **({"patience": args.patience}
                          if args.patience is not None else {}),
                       # the run reads back only its params-only best,
                       # and a full train state (2.50 GiB) takes 3.2-4.2 s
                       # to save on the card (chip_smoke.py's loop phase)
                       latest_every=10 ** 9)
    return SmartContractTrainer(
        SmartContractTransformer(run.cfg, seed=0), run.train_loader,
        run.val_loader, run.tok, config=tcfg, device=args.device,
        verbose=True)


def timed_epochs(trainer) -> List[Dict[str, float]]:
    """Record each epoch's wall seconds of training and validation, and
    its steps, as the trainer runs them."""
    epochs: List[Dict[str, float]] = []
    train_epoch, validate = trainer.train_epoch, trainer.validate

    def timed_train(epoch):
        t0 = time.perf_counter()
        out = train_epoch(epoch)
        epochs.append({"epoch": epoch + 1,
                       "train_s": time.perf_counter() - t0,
                       "steps": out["batches"],
                       "step_ms": out["step_time_ms"]})
        return out

    def timed_validate():
        t0 = time.perf_counter()
        out = validate()
        if epochs:
            epochs[-1]["val_s"] = time.perf_counter() - t0
        return out

    trainer.train_epoch, trainer.validate = timed_train, timed_validate
    return epochs


def within_minutes(minutes: Optional[float], t0: float):
    """A ``train(stop=)`` that ends the run when one more epoch of the mean
    length so far would pass ``minutes`` after ``t0`` (None: never)."""
    if minutes is None:
        return None

    def stop(epochs_run: int) -> bool:
        spent = time.time() - t0
        return spent + spent / epochs_run > minutes * 60
    return stop


def evaluate_run(args: argparse.Namespace, run: Run, ckpt_dir: str,
                 history: Dict[str, List[float]], train_secs: float) -> Dict:
    """The eval tail: the best checkpoint, the per-family matrix (or the
    validation split in CSV mode), the headline column (the opposite
    family), perplexity over the validation loader, ``summary.json``."""
    from ..evals.perplexity import compute_perplexity
    ckpt = best_checkpoint(ckpt_dir)
    print(f"evaluating checkpoint {ckpt}", flush=True)
    analyzer = load_analyzer(ckpt, run.cfg, run.tok, args.device)
    matrix = {}
    results = None
    if run.test_loaders:
        for name, loader in run.test_loaders.items():
            print(f"-- evaluating column {name} --", flush=True)
            res = score(analyzer, ckpt, loader,
                        os.path.join(args.out, f"evaluation_{name}.json"),
                        args.max_eval)
            matrix[name] = matrix_column(res)
            if results is None or name == f"fam{1 - args.train_family}":
                results = res
    else:
        results = score(analyzer, ckpt, run.val_loader,
                        os.path.join(args.out, "evaluation_results.json"),
                        args.max_eval)
    ppl = compute_perplexity(analyzer.model, run.val_loader)
    print(f"validation perplexity: {ppl['perplexity']:.2f} "
          f"(CE {ppl['cross_entropy']:.3f})", flush=True)
    summary = {
        "contracts": args.contracts,
        "train_family": args.train_family if args.corpus_v2 else None,
        "epochs_requested": args.epochs,
        "epochs_run": len(history["train_loss"]),
        "train_minutes": round(train_secs / 60, 2),
        "final_train_loss": history["train_loss"][-1],
        "best_val_loss": min(history["val_loss"]),
        "perplexity": ppl,
        "contract_overall": results["contract_level"]["overall"],
        "line_overall": results["line_level"]["overall"],
        "matrix": matrix or None,
        "checkpoint": ckpt,
    }
    write_json(os.path.join(args.out, "summary.json"), summary)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    import json
    args = parse_args(argv)
    resolve_device(args.device)         # no card: raise before any work
    run = build_run(args)
    trainer = build_trainer(args, run)
    epochs = timed_epochs(trainer)
    ckpt_dir = os.path.join(args.out, "checkpoints")
    t0 = time.time()
    history = trainer.train(args.epochs, checkpoint_dir=ckpt_dir,
                            stop=within_minutes(args.max_minutes, t0))
    train_secs = time.time() - t0
    print(f"training done in {train_secs / 60:.1f} min", flush=True)
    steps = sum(e["steps"] for e in epochs)
    write_json(os.path.join(args.out, "timing.json"), {
        "train_seconds": train_secs, "epochs_run": len(epochs),
        "seconds_per_epoch": train_secs / max(len(epochs), 1),
        "steps": steps,
        "step_ms": sum(e["train_s"] for e in epochs) * 1e3 / max(steps, 1),
        "epochs": epochs})
    del trainer, epochs                 # free the train state first
    gc.collect()
    summary = evaluate_run(args, run, ckpt_dir, history, train_secs)
    print(json.dumps(summary, indent=2, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
