"""Per-stage forward (and backward) attribution of the model at full size.

Port of the JAX repo's ``tools/time_fwd_modules.py`` on
``ModelConfig(use_gan=True)`` with random weights from seed 0, in eval
mode. Five stages, each timed on its own:

  encode          embeddings, 6 encoder layers, AST and cross attention,
                  fusion;
  contract_head   the contract pooling and head on the encoder's output;
  line_head       the line segment means, attentions and heads;
  decode+CE       the teacher-forced decoder, the LM head and an f32
                  log-softmax cross-entropy of the next token;
  discriminator   the GAN discriminator.

The stages after ``encode`` read one encoder output, computed once. A
stage's calls are chained through a scalar: each call adds the last one's
scalar (times 1e-30) to its input (the encoder output; ``encode`` to its
result) and returns the sum of its outputs in f32. The time of a call is
(T(44 calls) - T(4 calls)) / 40 by CUDA events (``bench.slope_ms``): a
warm-up chain of each length, then each T the fastest of 2 runs (5 on
the CPU's host clock), and further pairs of runs while T(44) is not
over T(4), up to a bound, past which it raises.
The JAX tool times one run of each length after one warm-up call: on a
loaded host that difference can come out negative.
``--grad`` also times each stage under autograd: the forward and
``torch.autograd.grad`` of its scalar over every model parameter it
reaches.

    python -m sct_gan_tpu_torch.tools.time_fwd_modules [--grad]
        [--batch 8] [--seq 1024]

Prints the JAX tool's lines with the card's name and power limit, then one
JSON line; ``--calls`` shortens the two runs.
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import resolve_device
from ._common import model_config
from .bench import add_size_args, card_or_device, emit, log, slope_ms, timed_ms

STAGES = ("encode", "contract_head", "line_head", "decode+CE",
          "discriminator")


def _scalar(out) -> torch.Tensor:
    """The f32 sum of every tensor in ``out`` (a tensor or a tuple)."""
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    return sum(x.float().sum() for x in leaves if x is not None)


def stage_fns(model, batch_size: int) -> Dict[str, Callable]:
    """Each stage as ``fn(c) -> f32 scalar``, ``c`` a 0-dim f32 tensor."""
    cfg = model.config
    dev = next(model.parameters()).device
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch_size, cfg.max_length), np.int32
    ).astype(np.int64)).to(dev)
    mask = torch.ones_like(ids)
    lines = torch.from_numpy(np.tile(np.minimum(
        np.arange(cfg.max_length) // 6, cfg.max_length - 1),
        (batch_size, 1))).to(dev)
    src = mask.bool()
    with torch.no_grad():
        memory = model.encode(ids, mask, ids, mask)
    fed = lambda c: memory + (c * 1e-30).to(memory.dtype)

    def decode_ce(c):
        logits = model.decode_teacher_forced(ids, fed(c), src)
        logp = F.log_softmax(logits.float(), dim=-1)
        return -logp[:, :-1].gather(-1, ids[:, 1:, None]).mean()

    return {
        "encode": lambda c: _scalar(model.encode(ids, mask, ids, mask))
        + c * 1e-30,
        "contract_head": lambda c: _scalar(model.contract_head(fed(c))[0]),
        "line_head": lambda c: _scalar(model.line_head(fed(c), lines)),
        "decode+CE": decode_ce,
        "discriminator": lambda c: _scalar(
            model.discriminator_forward(fed(c))),
    }


def with_grad(model, fn: Callable) -> Callable:
    """``fn`` under autograd: its scalar, after the gradient of it over
    every parameter it reaches."""
    params = [p for p in model.parameters() if p.requires_grad]

    def call(c):
        with torch.enable_grad():
            out = fn(c)
            torch.autograd.grad(out, params, allow_unused=True)
        return out.detach()
    return call


def call_ms(fn: Callable, device: torch.device, n_small: int = 4,
            n_large: int = 44) -> float:
    """ms of one call of a chain ``c = fn(c)``: ``bench.slope_ms`` of
    chains of ``n_small`` and ``n_large`` calls (a warm-up chain of each
    length, then each T the fastest of ``bench.REPS`` runs by CUDA events
    on the card, ``bench.HOST_REPS`` by the host clock on the CPU, the
    lengths interleaved, and further pairs of runs while T(n_large) <=
    T(n_small), up to a bound, past which it raises). Never <= 0."""
    box = [torch.zeros((), device=device)]

    def chain(n: int) -> None:
        for _ in range(n):
            box[0] = fn(box[0])

    def ms(n: int) -> float:
        ev, host = timed_ms(lambda: chain(n), device)
        return host if ev is None else ev

    per_call = slope_ms(ms, n_small, n_large, device,
                        "time_fwd_modules: a stage")
    if not torch.isfinite(box[0]):
        raise AssertionError("a stage's scalar is not finite")
    return per_call


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_size_args(ap)
    ap.add_argument("--grad", action="store_true",
                    help="also time forward + backward per stage")
    ap.add_argument("--calls", type=int, nargs=2, default=[4, 44],
                    metavar=("SHORT", "LONG"),
                    help="calls of the two timed runs (the JAX tool's 4 44)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_or_device(device)
    from ..models.sct_transformer import SmartContractTransformer
    cfg = model_config(args.seq, args.d_model, args.layers)
    model = SmartContractTransformer(cfg, seed=0).to(device).eval()
    log("params initialized")
    fns = stage_fns(model, args.batch)
    res: Dict[str, object] = {"card": card, "batch": args.batch,
                              "seq": args.seq,
                              "timing": ("CUDA events" if device.type == "cuda"
                                         else "host clock")}
    modes = [("fwd", lambda f: f)]
    if args.grad:
        modes.append(("fwd+bwd", lambda f: with_grad(model, f)))
    for mode, wrap in modes:
        times = {}
        for name in STAGES:
            with torch.no_grad():
                times[name] = call_ms(wrap(fns[name]), device, *args.calls)
            print(f"{mode} {name:14s}: {times[name]:7.3f} ms [{card}]",
                  flush=True)
        total = sum(times.values())
        print(f"{mode} sum: {total:.3f} ms [{card}]", flush=True)
        res[mode] = dict(times, sum=total)
    emit(res, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
