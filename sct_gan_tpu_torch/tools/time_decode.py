"""Time KV-cached decode on the card: one step alone, then full generation.

Port of the JAX repo's ``tools/time_decode.py`` on
``ModelConfig(use_gan=True)`` with random weights from seed 0:

  (a) one ``decode_step`` outside the generation loop, over the cross K/V
      and caches the generator builds, as the slope between runs of 4 and
      64 steps from position 0 (by CUDA events; ``bench.slope_ms``);
  (b) full-length generation through ``bench.time_decode``, the function
      of the training bench's decode leg and of ``bench_decode``.

    python -m sct_gan_tpu_torch.tools.time_decode [--batch 8] [--seq 1024]

Prints the JAX tool's two lines with the card's name and power limit, then
one JSON line. ``--rounds`` sets (b)'s long run (3, the JAX count).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..utils import resolve_device
from ._common import model_config, tokenizer_for
from .bench import (DECODE_ROUNDS, add_size_args, card_or_device, emit, log,
                    slope_ms, time_decode, timed_ms)

SHORT, LONG = 4, 64     # the JAX tool's step counts


@torch.inference_mode()
def decode_step_ms(model, batch_size: int) -> float:
    """ms of one ``decode_step``: ``bench.slope_ms`` of runs of SHORT and
    LONG steps, each from position 0 (the JAX tool times one run of each
    after a 2-step warm-up)."""
    cfg = model.config
    dev = next(model.parameters()).device
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch_size, cfg.max_length), np.int32
    ).astype(np.int64)).to(dev)
    mask = torch.ones_like(ids)
    memory = model.encode(ids, mask, ids, mask)
    cross_kvs = model.precompute_cross_kv(memory)
    caches = model.init_decode_cache(batch_size, dev)
    cur = torch.full((batch_size, 1), 1, dtype=torch.long, device=dev)
    src = mask.bool()

    def steps(n: int) -> None:
        for i in range(n):
            model.decode_step(cur, i, caches, cross_kvs, src)

    def ms(n: int) -> float:
        ev, host = timed_ms(lambda: steps(n), dev)
        return host if ev is None else ev

    return slope_ms(ms, SHORT, LONG, dev, "decode_step")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_size_args(ap)
    ap.add_argument("--rounds", type=int, default=DECODE_ROUNDS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_or_device(device)
    from ..models.sct_transformer import SmartContractTransformer
    cfg = model_config(args.seq, args.d_model, args.layers)
    model = SmartContractTransformer(cfg, seed=0).to(device).eval()
    log("params initialized")

    step = decode_step_ms(model, args.batch)
    print(f"decode_step alone: {step:.3f} ms/step [{card}]", flush=True)
    gen = time_decode(model, tokenizer_for(cfg), args.batch, args.rounds)
    b, per_round = args.batch, gen["seconds_per_batch"]
    per_tok = per_round / (cfg.max_length - 1)
    print(f"full generation: {per_round:.3f} s/batch of {b} -> "
          f"{gen['decode_contracts_per_sec']:.3f} contracts/s, "
          f"{gen['decode_tokens_per_sec']:.0f} tok/s "
          f"({per_tok * 1e3:.3f} ms/loop-step) [{card}]", flush=True)
    emit({"decode_step_ms": step, "seconds_per_batch": per_round,
          "contracts_per_sec": gen["decode_contracts_per_sec"],
          "decode_tokens_per_sec": gen["decode_tokens_per_sec"],
          "loop_step_ms": per_tok * 1e3, "batch": b, "seq": cfg.max_length,
          "step_timing": ("CUDA events" if device.type == "cuda"
                          else "host clock"),
          "card": card}, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
