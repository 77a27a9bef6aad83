"""Serving-side benchmark: KV-cached autoregressive generation throughput.

Port of the JAX repo's ``tools/bench_decode.py``: full-contract synthesis
(encode once + 1023 cached decode steps, temperature 0.7, top-k 50 /
top-p 0.95 sampling, the syntax boost, ``min_length=10**9`` so no row
stops early) in contracts/s and decoded tokens/s, on
``ModelConfig(use_gan=True)`` with random weights from seed 0 (f32
parameters, bf16 compute). The timing is ``bench.time_decode``'s, the
function the training bench's decode leg runs. Prints one JSON line with
the JAX tool's keys and the card's name and power limit.

    python -m sct_gan_tpu_torch.tools.bench_decode [BATCH]     # default 8
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from ..utils import resolve_device
from ._common import model_config, tokenizer_for
from .bench import add_size_args, card_or_device, emit, log, time_decode


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", type=int, nargs="?", default=8)
    add_size_args(ap, batch=False)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    from ..models.sct_transformer import SmartContractTransformer
    cfg = model_config(args.seq, args.d_model, args.layers)
    log("init params...")
    model = SmartContractTransformer(cfg, seed=0).to(device)
    dec = time_decode(model, tokenizer_for(cfg), args.batch)
    emit({"metric": "generation_throughput",
          "contracts_per_sec": dec["decode_contracts_per_sec"],
          "decode_tokens_per_sec": dec["decode_tokens_per_sec"],
          "batch": args.batch, "seq": cfg.max_length,
          "seconds_per_batch": dec["seconds_per_batch"],
          "card": card_or_device(device)}, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
