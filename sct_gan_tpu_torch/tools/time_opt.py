"""Time the optimizer stage alone on parameter-shaped gradients.

Port of the JAX repo's ``tools/time_opt.py``: one stage is the three-tier
clip, Adam, weight decay, the group learning rates and the skip gate over
the GAN model's parameters, with the gradients made from the parameters
(``p * 1e-3 + seed * 1e-9``, so each stage depends on the last), on the
JAX bench's trainer (``_common.bench_trainer``: ``ModelConfig(use_gan=True)``,
B=8, L=1024). The unfused chain (``train.optimizer.GradientTransform``) by
default, ``FusedOptimizer`` with ``--fused``. On the card the time is the
best mean of two runs of 10 stages by CUDA events after one warm-up stage,
and the launches are the device kernels ``torch.profiler`` records in one
stage; on the CPU the host clock, and no launches.

    python -m sct_gan_tpu_torch.tools.time_opt [--fused]

``--d-model`` and ``--layers`` (defaults: the bench's width) shrink the
model for tests; ``--out`` also writes the result as JSON.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import torch

from ..utils import resolve_device
from ._common import bench_trainer, write_json

REPS, STAGES = 2, 10            # the JAX tool's: best of 2 runs of 10


def stage_fn(trainer):
    """``stage(seed)``: synthesise the gradients and apply one optimizer
    update in place to the trainer's parameters and state."""
    opt = trainer.optimizer
    params = [trainer.state.params[n] for n in opt.names]
    state = trainer.state.opt_state
    lrs = trainer._group_lrs()
    loss = torch.zeros((), device=trainer.device)

    def stage(seed: float) -> None:
        grads = [p * 1e-3 + seed * 1e-9 for p in params]
        opt.update(grads, state, lrs, loss)
    return stage


def stage_launches(stage) -> int:
    """Device kernels (and copies) of one stage, by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stage(0.5)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def time_stage(trainer) -> Dict[str, object]:
    """ms per stage (best of ``REPS`` runs of ``STAGES``) and, on the card,
    launches per stage."""
    stage = stage_fn(trainer)
    cuda = trainer.device.type == "cuda"
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
    return {"ms": best, "launches": stage_launches(stage) if cuda else None,
            "parameters": len(trainer.optimizer.names)}


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
