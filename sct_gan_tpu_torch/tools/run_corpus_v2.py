"""The corpus-v2 Run B recipe end to end, through the port's tools.

In one process, each step through its tool's ``main``:

  1. ``train_synthetic --corpus-v2 --contracts 2000 --train-family 0
     --model-select detection --epochs N``: training, the best
     checkpoint's fam0 / fam1 / fam2 matrix, perplexity;
  2. ``eval_v2_infamily`` on that checkpoint (400 fresh family-0
     contracts, seed 2,000,000);
  3. ``analyze_v2_errors --family 2`` on it (200 contracts);
  4. the floor: an untrained model (``SmartContractTransformer(cfg,
     seed=0)``, saved by ``save_checkpoint``) through ``eval_v2_infamily``
     on the same set;
  5. ``time_opt``, unfused and ``--fused``.

Older best checkpoints are deleted as the run goes (``OlderBestsPruner``:
the newest two stay). ``--max-minutes`` ends the training after the last
epoch that fits (a prefix of the ``--epochs`` run: the schedule counts
epochs, not the total). Every result is a JSON file under ``--out``; ``--results`` also copies
them and the best checkpoint's sidecar (its epoch and the training
history to it; no arrays) to a directory of their own.

    python -m sct_gan_tpu_torch.tools.run_corpus_v2 --epochs 150 \\
        --out /tmp/sct_run_v2b --results runb_results

``run()``'s size arguments cut the run down for a smoke run (as
``chip_smoke.py`` does); their defaults are the recipe's.
"""
from __future__ import annotations

import argparse
import gc
import glob
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

from ..utils import resolve_device
from . import (analyze_v2_errors, eval_v2_infamily, time_opt,
               train_synthetic)
from ._common import best_checkpoint, model_config


def save_untrained(cfg, checkpoint_dir: str) -> str:
    """``SmartContractTransformer(cfg, seed=0)``'s parameters as a
    params-only checkpoint; returns its path."""
    from ..convert import flax_params_from_torch
    from ..models.sct_transformer import SmartContractTransformer
    from ..train.checkpoint import save_checkpoint
    model = SmartContractTransformer(cfg, seed=0)
    tree = {"params": flax_params_from_torch(dict(model.named_parameters()),
                                             cfg)}
    return save_checkpoint(checkpoint_dir, "best_model_untrained_epoch_0",
                           tree, {"epoch": 0, "params_only": True})


class OlderBestsPruner:
    """While the trainer runs, delete every best checkpoint of
    ``checkpoint_dir`` but the ``keep`` newest (by epoch), with their
    sidecars, every ``period`` seconds and once at ``close``. The trainer
    writes a best at each improvement and never reads one back, and the
    eval tail reads only the newest: at ~0.8 GB each, a long run's bests
    would fill the disk."""

    def __init__(self, checkpoint_dir: str, keep: int = 2,
                 period: float = 30.0):
        self.dir, self.keep, self.period = checkpoint_dir, keep, period
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="best-pruner")
        self._thread.start()

    def prune(self) -> None:
        if not os.path.isdir(self.dir):
            return
        bests = sorted((e for e in os.listdir(self.dir)
                        if e.startswith("best_model")
                        and os.path.isdir(os.path.join(self.dir, e))),
                       key=lambda e: int(e.rsplit("_", 1)[1]))
        for name in bests[:-self.keep]:
            path = os.path.join(self.dir, name)
            shutil.rmtree(path, ignore_errors=True)
            if os.path.exists(path + ".meta.json"):
                os.remove(path + ".meta.json")

    def _loop(self) -> None:
        while not self._done.wait(self.period):
            self.prune()

    def close(self) -> None:
        self._done.set()
        self._thread.join()
        self.prune()


def run(out: str, epochs: int, device: str = "cuda", contracts: int = 2000,
        eval_contracts: Optional[int] = None, n_infamily: int = 400,
        n_errors: int = 200, d_model: int = 768, layers: int = 6,
        seq: int = 1024, max_minutes: Optional[float] = None
        ) -> Dict[str, float]:
    """Steps 1-5 into ``out``; returns each step's wall seconds.
    ``max_minutes`` bounds the training (``train_synthetic
    --max-minutes``)."""
    size = ["--d-model", str(d_model), "--layers", str(layers),
            "--seq", str(seq), "--device", device]
    secs: Dict[str, float] = {}

    def step(name, fn, argv):
        t0 = time.perf_counter()
        rc = fn(argv)
        gc.collect()
        secs[name] = time.perf_counter() - t0
        print(f"run_corpus_v2: {name} done in {secs[name]:.1f} s (rc {rc})",
              flush=True)
        if rc:
            raise RuntimeError(f"{name} returned {rc}")

    pruner = OlderBestsPruner(os.path.join(out, "checkpoints"))
    try:
        step("train_synthetic", train_synthetic.main, [
            "--corpus-v2", "--contracts", str(contracts),
            "--train-family", "0", "--model-select", "detection",
            "--epochs", str(epochs), "--out", out, *size,
            *(["--eval-contracts", str(eval_contracts)] if eval_contracts
              else []),
            *(["--max-minutes", str(max_minutes)] if max_minutes else [])])
    finally:
        pruner.close()
    best = best_checkpoint(os.path.join(out, "checkpoints"))
    step("eval_v2_infamily", eval_v2_infamily.main,
         ["--run", out, "--n", str(n_infamily), *size])
    step("analyze_v2_errors", analyze_v2_errors.main, [
        "--ckpt", best, "--family", "2", "--contracts", str(n_errors),
        "--out", os.path.join(out, "errors_fam2.json"), *size])
    floor = os.path.join(out, "untrained")
    ckpt = save_untrained(model_config(seq, d_model, layers),
                          os.path.join(floor, "checkpoints"))
    step("eval_v2_infamily_untrained", eval_v2_infamily.main,
         ["--run", floor, "--ckpt", ckpt, "--n", str(n_infamily), *size])
    shutil.rmtree(os.path.join(floor, "checkpoints"))
    opt = ["--d-model", str(d_model), "--layers", str(layers),
           "--device", device]
    step("time_opt", time_opt.main,
         [*opt, "--out", os.path.join(out, "time_opt.json")])
    step("time_opt_fused", time_opt.main,
         [*opt, "--fused", "--out", os.path.join(out, "time_opt_fused.json")])
    return secs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--out", default="/tmp/sct_run_v2b")
    ap.add_argument("--results", default="",
                    help="also copy the JSON results here")
    ap.add_argument("--max-minutes", type=float, default=None,
                    help="bound the training (train_synthetic "
                         "--max-minutes)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    secs = run(args.out, args.epochs, args.device,
               max_minutes=args.max_minutes)
    print(f"run_corpus_v2: step seconds {secs}", flush=True)
    if args.results:
        os.makedirs(args.results, exist_ok=True)
        for path in glob.glob(os.path.join(args.out, "**", "*.json"),
                              recursive=True):
            if "checkpoints" in os.path.relpath(path, args.out):
                continue
            rel = os.path.relpath(path, args.out).replace(os.sep, "_")
            shutil.copy(path, os.path.join(args.results, rel))
        # the best checkpoint's sidecar: its epoch and the history to it
        best = best_checkpoint(os.path.join(args.out, "checkpoints"))
        shutil.copy(best + ".meta.json",
                    os.path.join(args.results, "best_checkpoint.meta.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
