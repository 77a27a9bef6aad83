"""Forward against backward plus optimizer, from the trainer's own steps.

Port of the JAX repo's ``tools/time_fwd.py``, on the bench's trainer
(``bench.build_trainer("bfloat16", False, 8, 1024)``)::

    full train step = forward (train losses) + backward + optimizer + metrics
    eval step       = forward (eval-mode losses) only

The train step is timed as ``bench.time_step`` times it; the eval step
(``trainer.eval_step``) as a chain of 10, each feeding its loss back into
the next's line-vulnerability weight at 1e-20 (data-dependent without
changing the math), best of 2 after 2 warm-up calls, by CUDA events. The
difference is the backward, the optimizer and the train step's extras.

    python -m sct_gan_tpu_torch.tools.time_fwd

Prints the JAX tool's three lines with the card's name and power limit,
then one JSON line; ``--steps`` shortens both runs.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from .bench import (STEPS, add_size_args, best_of, build_trainer,
                    card_or_device, emit, log, make_batch, time_step,
                    timed_ms)


def time_eval(trainer, batch, n: int = STEPS, warmup: int = 2, reps: int = 2):
    """ms of one ``eval_step`` in a chain (``bench.best_of``'s keys)."""
    device_batch = trainer.to_device(batch)
    box = {"scalars": trainer._scalars(1.0)}

    def chain(k: int) -> None:
        for _ in range(k):
            sc = box["scalars"]
            loss = trainer.eval_step(device_batch, sc)["total_loss"]
            box["scalars"] = sc._replace(
                line_vuln_weight=sc.line_vuln_weight + loss * 1e-20)

    for _ in range(warmup):
        timed_ms(lambda: chain(1), trainer.device)
    return best_of(lambda: timed_ms(lambda: chain(n), trainer.device), reps,
                   n)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_size_args(ap)
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="steps a timed run (the JAX tool's 10)")
    args = ap.parse_args(argv)
    trainer = build_trainer("bfloat16", False, args.batch, args.seq,
                            args.device, args.d_model, args.layers)
    card = card_or_device(trainer.device)
    batch = make_batch(args.batch, args.seq, trainer.model.config.vocab_size)

    log("timing full train step...")
    step = time_step(trainer, batch, n_large=args.steps)
    full = step["ms"]
    print(f"full step: {full:.2f} ms [{card}]", flush=True)
    log("timing eval (fwd-only) step...")
    ev = time_eval(trainer, batch, args.steps)
    fwd = ev["ms"]
    print(f"eval (fwd-only) step: {fwd:.2f} ms [{card}]", flush=True)
    print(f"=> bwd+optimizer+train-extras: {full - fwd:.2f} ms [{card}]",
          flush=True)
    emit({"step_ms": full, "fwd_ms": fwd, "bwd_opt_ms": full - fwd,
          "step_host_ms": step["host_ms"], "fwd_host_ms": ev["host_ms"],
          "timing": step["timing"],
          "card": card, "batch": args.batch, "seq": args.seq}, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
