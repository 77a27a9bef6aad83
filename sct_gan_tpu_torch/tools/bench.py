"""The port's training benchmark: fused GAN train-step throughput on the card.

Port of the JAX repo's root ``bench.py``. Prints ONE JSON line with the
JAX bench's keys::

    {"metric": "train_tokens_per_sec_per_chip", "value": N,
     "unit": "tokens/s/chip", "vs_baseline": R,
     "decode_contracts_per_sec": C, "decode_tokens_per_sec": T,
     "decode_batch": 64, ...}

and beside them the card's name and power limit, the step's ms by CUDA
events and by the host clock, the naive leg's, the decode round's seconds
and the kernel launches of each leg.

The model is ``ModelConfig(use_gan=True)`` at L=1024 (d=768, 8 heads of 96,
6+6 layers, FFN 2048, vocab 50265 padded to 50304, bf16 compute, f32
parameters); the step is the JAX bench's: B=8, dropout 0.3, the fused LM
cross-entropy and ``FusedOptimizer`` (``_common.bench_trainer``).

Timing. A run is n chained ``train_step`` calls (each takes the last one's
state) between two synchronisations, timed by CUDA events and, over the
same window, by the host clock; the step's time is the best of 2 runs of
10 after 2 warm-up steps (the JAX counts). The events span the host's
launch gaps too, so on a host-bound step they time the host.

``vs_baseline`` is the speed-up over the naive leg, measured in the same
run: what a line-for-line port would run, f32 compute with dense attention
(the JAX bench's ``build_trainer("float32", False, ...)``). The port has no
attention switch (the device picks the kernel), so the bench assembles the
leg itself: ``dense_attention`` rebinds the attention the model's layers
call to the plain ``ops/attention.py`` ``mha_reference`` while the naive
trainer is built and while each of its steps runs. Its dropout sites still
launch the dropout kernel, as the JAX naive build keeps its dropout. TF32
stays off (torch's default for f32 matmuls): the line says so.

Decode: encode once, then 1023 cached sampling steps at temperature 0.7
with the syntax boost and ``min_length=10**9`` (no row stops early), at
B=64; per round, (T(3 rounds) - T(1 round)) / 2 by the host clock between
synchronisations (the loop syncs every token), after a warm-up run of
each length, each T the fastest of 2 runs; a long run no longer than the
short one is timed again and in the end raises (``time_decode``).

    python -m sct_gan_tpu_torch.tools.bench

``--device cpu`` with ``--d-model``, ``--layers``, ``--seq``, ``--batch``
and ``--decode-batch`` runs the plain versions at a small size; its
numbers are the CPU's, and the line names the device.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import resolve_device
from ._common import bench_trainer, write_json

BATCH, SEQ, DECODE_BATCH = 8, 1024, 64
WARMUP, STEPS, REPS = 2, 10, 2      # the JAX bench's step counts
NAIVE_STEPS = 4                     # bench.py:200
DECODE_ROUNDS = 3                   # the long run; the short run is 1
TEMPERATURE = 0.7
HOST_REPS = 5       # runs of each length of a slope timed on the CPU
MORE_PAIRS = 10     # further pairs of runs while a slope is not positive
TRACES = 3          # profiled runs of device_ms before an empty trace raises


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_batch(batch_size: int, seq: int, vocab: int):
    """The JAX bench's training batch (``bench.py:57-70``), bit for bit."""
    rng = np.random.default_rng(0)
    lines = np.minimum(np.arange(seq, dtype=np.int32) // 6, seq - 1)
    return {
        "input_ids": rng.integers(0, vocab, (batch_size, seq)).astype(np.int32),
        "attention_mask": np.ones((batch_size, seq), np.int32),
        "ast_input_ids": rng.integers(0, vocab, (batch_size, seq)).astype(np.int32),
        "ast_attention_mask": np.ones((batch_size, seq), np.int32),
        "token_to_line": np.tile(lines, (batch_size, 1)),
        "vulnerable_lines": (rng.random((batch_size, 8, seq)) < 0.01
                             ).astype(np.int32),
        "contract_vulnerabilities": rng.integers(
            0, 2, (batch_size, 8)).astype(np.int32),
    }


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the main path's kernel wrappers (each adds one
    where it launches its kernel; on the CPU they stay 0)."""
    from ..ops.decode_attention import decode_attention
    from ..ops.dropout import dropout
    from ..ops.flash_attention import (flash_attention,
                                       flash_attention_backward)
    return {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_bwd": flash_attention_backward.launches,
            "dropout": dropout.launches,
            "decode_attention": decode_attention.launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}


@contextlib.contextmanager
def dense_attention():
    """Rebind the attention the model's layers call
    (``models.layers.dot_product_attention``, the flash kernel on the card)
    to the plain dense ``ops.attention.mha_reference``, which computes in
    its inputs' dtype (f32 in the naive leg); restored on exit, also when
    the body raises."""
    from ..models import layers
    from ..ops.attention import mha_reference
    previous = layers.dot_product_attention
    layers.dot_product_attention = mha_reference
    try:
        yield
    finally:
        layers.dot_product_attention = previous


def _under_dense(fn: Callable) -> Callable:
    def call(*args, **kwargs):
        with dense_attention():
            return fn(*args, **kwargs)
    return call


def build_trainer(compute_dtype: str, dense: bool, batch_size: int = BATCH,
                  seq: int = SEQ, device: str = "cuda", d_model: int = 768,
                  layers: int = 6):
    """The JAX bench's ``build_trainer(compute_dtype, use_flash, batch_size,
    seq)`` (``bench.py:29-54``) over ``_common.bench_trainer``. ``dense``
    (the JAX ``use_flash=False``) builds the trainer and runs each of its
    train and eval steps under ``dense_attention``; ``d_model`` and
    ``layers`` shrink the model for tests. Raises first, before any
    model is built, when ``device`` is a card that is not there."""
    resolve_device(device)
    if not dense:
        return bench_trainer(device, True, d_model, layers, seq, batch_size,
                             compute_dtype)
    with dense_attention():
        trainer = bench_trainer(device, True, d_model, layers, seq,
                                batch_size, compute_dtype)
    trainer.train_step = _under_dense(trainer.train_step)
    trainer.eval_step = _under_dense(trainer.eval_step)
    return trainer


def timed_ms(run: Callable[[], object], device: torch.device
             ) -> Tuple[Optional[float], float]:
    """Run ``run()`` once between two synchronisations: (ms by CUDA events,
    None on the CPU; ms by the host clock over the same window)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    run()
    if cuda:
        end.record()
        torch.cuda.synchronize(device)
    host = (time.perf_counter() - t0) * 1e3
    return (start.elapsed_time(end) if cuda else None), host


def device_ms(run: Callable[[], object], units: int,
              device: torch.device) -> Tuple[Optional[float], int]:
    """(Device ms a unit of ``run()``, which runs ``units`` units; the runs
    made): the summed device time of its kernels under ``torch.profiler``
    (no host gap counted), over one run; on the CPU the run is made,
    unprofiled, and the ms is None. Set beside a time by CUDA events, it
    gives the card's busy share. ``run()`` launches kernels, so a trace
    with no device time lost its records (in a long process the profiler
    drops some, and now and then all): the run is profiled again, up to
    ``TRACES`` runs, and past them it raises."""
    if device.type != "cuda":
        run()
        return None, 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for runs in range(1, TRACES + 1):
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            run()
            torch.cuda.synchronize(device)
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / units / 1e3, runs
    raise RuntimeError(f"torch.profiler recorded no device time in {TRACES} "
                       "traces of a run that launches kernels")


def slope_ms(run_ms: Callable[[int], float], n_small: int, n_large: int,
             device: torch.device, what: str) -> float:
    """ms a unit by the slope of two run lengths, (T(n_large) -
    T(n_small)) / (n_large - n_small); ``run_ms(n)`` times one run of n
    units on ``device``. Each length runs once to warm up, then ``REPS``
    times on the card, ``HOST_REPS`` on the CPU, the two lengths
    interleaved, and each T is the fastest of its runs (a busy host only
    ever adds time). A long run that took no longer than a short
    one was disturbed (on a host whose load falls while the runs go on,
    the last and longest run is the quietest): then up to ``MORE_PAIRS``
    further pairs of runs are taken, and past them it raises. It never
    returns a time <= 0."""
    reps = REPS if device.type == "cuda" else HOST_REPS
    run_ms(n_small)
    run_ms(n_large)
    small = large = float("inf")
    pairs = 0
    while pairs < reps or (large <= small and pairs < reps + MORE_PAIRS):
        small = min(small, run_ms(n_small))
        large = min(large, run_ms(n_large))
        pairs += 1
    if not large > small:
        raise RuntimeError(
            f"{what}: the fastest of {pairs} runs of {n_large} took "
            f"{large:.3f} ms, no longer than the fastest of {n_small}, "
            f"{small:.3f} ms: the host is too loaded to time it by the "
            f"slope of two run lengths")
    return (large - small) / (n_large - n_small)


def best_of(run: Callable[[], Tuple[Optional[float], float]], reps: int,
            n: int) -> Dict[str, object]:
    """The fastest of ``reps`` runs of ``n`` calls, per call: ``ms`` by
    CUDA events on the card, by the host clock on the CPU (``timing``
    says which), and ``host_ms``, the host clock over the same run."""
    ev, host = min((run() for _ in range(reps)),
                   key=lambda t: t[1] if t[0] is None else t[0])
    return {"ms": (host if ev is None else ev) / n, "host_ms": host / n,
            "timing": "host clock" if ev is None else "CUDA events"}


def time_step(trainer, batch, warmup: int = WARMUP, n_large: int = STEPS,
              reps: int = REPS) -> Dict[str, object]:
    """ms a train step: ``warmup`` steps, then the best of ``reps`` runs of
    ``n_large`` chained steps (``best_of``'s keys), the steps run and their
    kernel launches; ``trainer.state`` holds the last state after."""
    device_batch = trainer.to_device(batch)
    lrs = trainer._group_lrs()
    box = {"state": trainer.state, "scalars": trainer._scalars(1.0)}

    def steps(n: int) -> None:
        for _ in range(n):
            box["state"], _, box["scalars"] = trainer.train_step(
                box["state"], device_batch, box["scalars"], lrs,
                trainer.generator)

    before = kernel_launches()
    for _ in range(warmup):
        timed_ms(lambda: steps(1), trainer.device)
    best = best_of(lambda: timed_ms(lambda: steps(n_large), trainer.device),
                   reps, n_large)
    trainer.state = box["state"]
    return dict(best, steps=warmup + reps * n_large,
                launches=_since(before))


def time_decode(model, tokenizer, batch_size: int,
                n_large: int = DECODE_ROUNDS) -> Dict[str, object]:
    """KV-cached generation throughput (``bench.py:126-167``,
    ``tools/bench_decode.py``): a round encodes B random contracts of the
    model's length once and samples L - 1 tokens (temperature 0.7, the
    syntax boost, no early stop), timed by the host clock between
    synchronisations. A round takes ``slope_ms`` of runs of 1 and
    ``n_large`` rounds: a warm-up run of each length, then the fastest of
    ``REPS`` runs of each on the card (each run lasts seconds there),
    ``HOST_REPS`` on the CPU, and further pairs of runs while the long
    run is not the longer, up to a bound, past which it raises. The JAX
    ``bench.py:163`` times one run of each length after one warm-up round
    and clamps the slope at 1e-9 s, so a disturbed run printed about B·1e9
    contracts/s; here it raises instead. Raises if a round stops before
    L - 1 steps. The model is put in eval mode for the rounds."""
    from ..infer.generate import make_generate_fn, syntax_boost_ids
    if n_large < 2:
        raise ValueError(f"n_large {n_large}: the slope needs 2 or more")
    cfg = model.config
    dev = next(model.parameters()).device
    seq = cfg.max_length
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch_size, seq),
                                        dtype=np.int32).astype(np.int64)
                           ).to(dev)
    mask = torch.ones_like(ids)
    generate = make_generate_fn(model, syntax_boost_ids(tokenizer),
                                min_length=10 ** 9)
    done = [0]                          # rounds run; each its own seed

    def rounds_ms(n: int) -> float:
        def run() -> None:
            for _ in range(n):
                with torch.inference_mode():
                    memory = model.encode(ids, mask, ids, mask)
                gen = torch.Generator(device=dev).manual_seed(done[0])
                done[0] += 1
                _, steps = generate(memory, mask.bool(), gen, TEMPERATURE)
                if steps != seq - 1:
                    raise AssertionError(f"decode round: {steps} steps, "
                                         f"expected {seq - 1}")
        return timed_ms(run, dev)[1]

    was_training = model.training
    model.eval()
    before = kernel_launches()
    try:
        per_round = slope_ms(rounds_ms, 1, n_large, dev,
                             "decode round") / 1e3
    finally:
        model.train(was_training)
    return {"decode_contracts_per_sec": batch_size / per_round,
            "decode_tokens_per_sec": batch_size * (seq - 1) / per_round,
            "seconds_per_batch": per_round, "rounds": done[0],
            "steps": done[0] * (seq - 1), "launches": _since(before)}


def card_or_device(device: torch.device) -> str:
    """The card's name and power limit on the card, else the device."""
    if device.type == "cuda":
        from ..utils.profiling import card_line
        return card_line()
    return str(device)


def free_memory() -> None:
    """Collect what the caller dropped and return the card's cached
    blocks, as ``bench.py:192-195`` frees the fused state before the naive
    build."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(args) -> Dict[str, object]:
    device = resolve_device(args.device)
    card = card_or_device(device)
    tokens = args.batch * args.seq
    kw = dict(device=args.device, d_model=args.d_model, layers=args.layers)
    before = kernel_launches()

    log("building the fused trainer (bf16, flash attention)...")
    fused = build_trainer("bfloat16", False, args.batch, args.seq, **kw)
    batch = make_batch(args.batch, args.seq, fused.model.config.vocab_size)
    log("timing the fused step...")
    step = time_step(fused, batch)
    step_ms = step["ms"]
    log(f"fused: {step_ms:.2f} ms/step = {tokens / step_ms * 1e3:,.0f} "
        f"tokens/s [{card}]")
    log("timing KV-cached decode...")
    decode = time_decode(fused.model, fused.tokenizer, args.decode_batch)
    log(f"decode at B={args.decode_batch}: {decode['seconds_per_batch']:.3f}"
        f" s a round [{card}]")
    del fused
    free_memory()

    log("building the naive trainer (f32, dense attention)...")
    naive = build_trainer("float32", True, args.batch, args.seq, **kw)
    log("timing the naive step...")
    naive_step = time_step(naive, batch, n_large=NAIVE_STEPS)
    naive_ms = naive_step["ms"]
    log(f"naive: {naive_ms:.2f} ms/step = {tokens / naive_ms * 1e3:,.0f} "
        f"tokens/s [{card}]")
    del naive
    free_memory()

    return {
        "metric": "train_tokens_per_sec_per_chip",
        "value": tokens / step_ms * 1e3,
        "unit": "tokens/s/chip",
        "vs_baseline": naive_ms / step_ms,
        "decode_contracts_per_sec": decode["decode_contracts_per_sec"],
        "decode_tokens_per_sec": decode["decode_tokens_per_sec"],
        "decode_batch": args.decode_batch,
        "card": card,
        "device": str(device),
        "timing": step["timing"],
        "step_ms": step_ms, "step_host_ms": step["host_ms"],
        "naive_step_ms": naive_ms,
        "naive_step_host_ms": naive_step["host_ms"],
        "naive_tokens_per_sec": tokens / naive_ms * 1e3,
        "naive_leg": "float32 compute, dense attention (mha_reference), "
                     "dropout kernel kept",
        "tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "decode_seconds_per_batch": decode["seconds_per_batch"],
        "batch": args.batch, "seq": args.seq,
        "launches": {"step": dict(step["launches"], steps=step["steps"]),
                     "naive_step": dict(naive_step["launches"],
                                        steps=naive_step["steps"]),
                     "decode": dict(decode["launches"],
                                    rounds=decode["rounds"],
                                    steps=decode["steps"]),
                     "total": _since(before)},
    }


def add_size_args(ap: argparse.ArgumentParser, batch: bool = True) -> None:
    """The options the bench tools share: the device and the model's size
    (the JAX bench's by default); ``batch=False`` leaves ``--batch`` out."""
    ap.add_argument("--device", default="cuda")
    if batch:
        ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--out", default="", help="also write the JSON here")


def emit(res: Dict[str, object], out: str) -> None:
    print(json.dumps(res), flush=True)
    if out:
        write_json(out, res)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_size_args(ap)
    ap.add_argument("--decode-batch", type=int, default=DECODE_BATCH)
    args = ap.parse_args(argv)
    emit(run(args), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
