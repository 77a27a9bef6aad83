"""Profile the fused GAN train step and print the top device operations by
self time.

Port of the JAX repo's ``tools/profile_step.py``: the bench's trainer
(``bench.build_trainer("bfloat16", False)``: ``ModelConfig(use_gan=True)``,
B=8, L=1024, dropout 0.3, the fused LM cross-entropy and
``FusedOptimizer``) runs two warm-up steps, then ``--steps`` chained steps
under ``torch.profiler``; the JAX tool's table follows, the top
``--topk`` device kernels by summed self time over the traced steps::

    == torch.profiler device trace: 6 steps, ... [card]
    -- CUDA  (sum 471.2 ms, 180 distinct ops) [card]
         78.123 ms  x138    void flash_fwd_hopper_kernel<...> [card]

The JAX tool writes an XPlane dump (``--logdir``) and parses it
(``--parse-only``); here the records are read in the process, so neither
option is ported. They are read through ``utils.profiling.trace_device``:
each trace opens with primer kernels, a trace that lost records of the
steps (no primer left, or the port's kernels short of the launch
counters) is taken again, and the rows come only from a whole trace.
The header also gives the steps' time by CUDA events over an unprofiled
run of the same length, and the card's busy share.

    python -m sct_gan_tpu_torch.tools.profile_step [--steps 6] [--topk 40]

``--device cpu`` with ``--d-model``, ``--layers``, ``--seq``, ``--batch``
and ``--vocab`` profiles the plain versions at a small size, by the CPU
ops' self time. The last line is one JSON object.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from ..utils import resolve_device
from ..utils.profiling import trace_device
from .bench import (add_size_args, build_trainer, card_or_device, emit,
                    make_batch, timed_ms)

WARMUP = 2


def print_top(rows, topk: int, card: str, per: float = 1.0) -> None:
    """The JAX tool's rows: summed ms (over ``per`` units), count and name
    of the ``topk`` first of ``rows`` (kernel, records, µs), each with the
    card it ran on."""
    for name, count, us in rows[:topk]:
        print(f"  {us / per / 1e3:10.3f} ms  x{count / per:<6g} "
              f"{name[:130]} [{card}]")


def run(args) -> Dict[str, object]:
    device = resolve_device(args.device)
    card = card_or_device(device)
    trainer = build_trainer("bfloat16", False, args.batch, args.seq,
                            device=args.device, d_model=args.d_model,
                            layers=args.layers, vocab=args.vocab)
    batch = trainer.to_device(make_batch(args.batch, args.seq,
                                         trainer.model.config.vocab_size))
    lrs = trainer._group_lrs()
    box = {"state": trainer.state, "scalars": trainer._scalars(1.0)}

    def steps(n: int) -> None:
        for _ in range(n):
            box["state"], _, box["scalars"] = trainer.train_step(
                box["state"], batch, box["scalars"], lrs, trainer.generator)

    for _ in range(WARMUP):
        timed_ms(lambda: steps(1), device)
    events_ms, host_ms = timed_ms(lambda: steps(args.steps), device)
    wall_ms = host_ms if events_ms is None else events_ms
    cpu = device.type != "cuda"
    trace = trace_device(lambda: steps(args.steps), cpu=cpu)
    n = args.steps
    top = [r for r in trace.rows if r[2] > 0][:args.topk]
    dev_ms = trace.total_us / n / 1e3
    group = "CPU" if cpu else "CUDA"
    share = "" if cpu else f" ({dev_ms * n / wall_ms:.1%} busy)"
    print(f"== torch.profiler {'host' if cpu else 'device'} trace: {n} "
          f"steps (B={args.batch}, L={args.seq}) after {WARMUP} warm-up, "
          f"{dev_ms:.3f} ms a step against {wall_ms / n:.3f} by "
          f"{'the host clock' if cpu else 'CUDA events'}{share}, whole "
          f"after {trace.runs} trace(s) [{card}]")
    print(f"\n-- {group}  (sum {trace.total_us / 1e3:.2f} ms, "
          f"{len(trace.rows)} distinct ops) [{card}]")
    print_top(top, args.topk, card)
    return {"card": card, "device": str(device), "steps": n,
            "batch": args.batch, "seq": args.seq, "warmup": WARMUP,
            "trace_ms_per_step": dev_ms, "wall_ms_per_step": wall_ms / n,
            "timing": "host clock" if cpu else "CUDA events",
            "records_per_step": trace.records / n,
            "traced_runs": trace.runs,
            "top": [{"name": k, "count": c, "ms": us / 1e3}
                    for k, c, us in top]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_size_args(ap, vocab=True)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--topk", type=int, default=40)
    args = ap.parse_args(argv)
    emit(run(args), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
