"""Quick iteration bench: the fused train step and decode only, no naive leg.

Port of the JAX repo's ``tools/quick_bench.py``: ``bench.py``'s timing
(``bench.time_step``, ``bench.time_decode``) on the bench's trainer,
without the f32 dense-attention leg. Prints one JSON line: ``step_ms``
and ``tok_per_sec`` (unless ``--no-step``), the decode rates and
``decode_batch`` (unless ``--no-decode``), with the card's name and power
limit and the step's ms by the host clock beside its CUDA-event ms.

    python -m sct_gan_tpu_torch.tools.quick_bench [--no-step] [--no-decode]
        [--decode-batch N]

The JAX tool's ``--sorted-embed`` is not ported: it toggles a JAX-only
knob (``ModelConfig.sorted_embed_grad``) that the port does not read.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from .bench import (add_size_args, build_trainer, card_or_device, emit,
                    make_batch, time_decode, time_step)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-decode", action="store_true")
    ap.add_argument("--no-step", action="store_true")
    ap.add_argument("--decode-batch", type=int, default=32)
    add_size_args(ap)
    args = ap.parse_args(argv)

    trainer = build_trainer("bfloat16", False, args.batch, args.seq,
                            args.device, args.d_model, args.layers)
    out = {"card": card_or_device(trainer.device)}
    if not args.no_step:
        batch = make_batch(args.batch, args.seq,
                           trainer.model.config.vocab_size)
        step = time_step(trainer, batch)
        out.update(step_ms=step["ms"],
                   tok_per_sec=args.batch * args.seq / step["ms"] * 1e3,
                   step_host_ms=step["host_ms"], timing=step["timing"])
    if not args.no_decode:
        dec = time_decode(trainer.model, trainer.tokenizer,
                          args.decode_batch)
        out.update(decode_contracts_per_sec=dec["decode_contracts_per_sec"],
                   decode_tokens_per_sec=dec["decode_tokens_per_sec"],
                   decode_batch=args.decode_batch)
    emit(out, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
