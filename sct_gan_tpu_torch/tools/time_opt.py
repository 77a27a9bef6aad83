"""Time the optimizer stage alone on parameter-shaped gradients.

Port of the JAX repo's ``tools/time_opt.py``: one stage is the three-tier
clip, Adam, weight decay, the group learning rates and the skip gate over
the GAN model's parameters, with the gradients made from the parameters
(``p * 1e-3 + seed * 1e-9``, so each stage depends on the last), on the
JAX bench's trainer (``_common.bench_trainer``: ``ModelConfig(use_gan=True)``,
B=8, L=1024). The unfused chain (``train.optimizer.GradientTransform``) by
default, ``FusedOptimizer`` with ``--fused``. On the card the time is the
best mean of two runs of 10 stages by CUDA events after one warm-up stage,
and the launches are the device kernels of one stage in a whole
``torch.profiler`` trace (``utils.profiling.trace_device``); on the CPU
the host clock, and no launches.

    python -m sct_gan_tpu_torch.tools.time_opt [--fused]

``--d-model`` and ``--layers`` (defaults: the bench's width) shrink the
model for tests; ``--out`` also writes the result as JSON.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional

import torch

from ..utils import resolve_device
from ..utils.profiling import trace_device
from ._common import bench_trainer, write_json

REPS, STAGES = 2, 10            # the JAX tool's: best of 2 runs of 10


def optimizer_stage(opt, opt_state, lrs, params):
    """``stage(seed)``: synthesise the gradients of ``params`` (``opt``'s
    parameters) from them and apply one update of ``opt`` in place to
    them and ``opt_state``."""
    loss = torch.zeros((), device=params[0].device)

    def stage(seed: float) -> None:
        grads = [p * 1e-3 + seed * 1e-9 for p in params]
        opt.update(grads, opt_state, lrs, loss)
    return stage


def stage_fn(trainer):
    """``optimizer_stage`` of the trainer's optimizer, parameters and
    state."""
    opt = trainer.optimizer
    return optimizer_stage(opt, trainer.state.opt_state,
                           trainer._group_lrs(),
                           [trainer.state.params[n] for n in opt.names])


def time_stages(stage: Callable[[float], None], device: torch.device
                ) -> Dict[str, object]:
    """ms per stage (best of ``REPS`` runs of ``STAGES`` after one warm-up
    stage; CUDA events on the card, the host clock on the CPU) and, on
    the card, the device kernels of one stage, from a whole
    ``torch.profiler`` trace (``utils.profiling.trace_device``)."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stage(0.0)                  # warm-up
    sync()
    best = float("inf")
    for rep in range(REPS):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        for i in range(STAGES):
            stage(float(rep * STAGES + i))
        if cuda:
            end.record()
            sync()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / STAGES)
    launches = trace_device(lambda: stage(0.5)).records if cuda else None
    return {"ms": best, "launches": launches}


def time_stage(trainer) -> Dict[str, object]:
    """``time_stages`` of the trainer's optimizer, with its parameter
    count."""
    return dict(time_stages(stage_fn(trainer), trainer.device),
                parameters=len(trainer.optimizer.names))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fused", action="store_true",
                    help="time FusedOptimizer instead of the per-leaf "
                         "chain")
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    trainer = bench_trainer(args.device, args.fused, args.d_model,
                            args.layers)
    res = time_stage(trainer)
    mode = "FusedOptimizer" if args.fused else "GradientTransform"
    where = "CUDA events" if device.type == "cuda" else "host clock"
    if device.type == "cuda":
        from ..utils.profiling import card_line
        where += f", {card_line()}"
    res = dict(res, optimizer=mode, device=str(device))
    print(f"optimizer stage ({mode}, incl. grad synth + keep): "
          f"{res['ms']:.3f} ms, {res['launches']} launches over "
          f"{res['parameters']} parameters [{where}]", flush=True)
    print(json.dumps(res), flush=True)
    if args.out:
        write_json(args.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
