"""Measure the card's achievable bf16 matmul TFLOP/s and HBM bandwidth.

Port of the JAX repo's ``tools/peak_matmul.py``: the speed of light for an
MFU or roofline share, measured rather than read from the data sheet. A
chain of 16 data-dependent square bf16 matmuls ``x = x @ a`` at n = 4096
and 8192 (``a`` holds 1e-4, so the chain stays finite: the JAX tool scales
each product by 1e-4 in the matmul's epilogue instead, which XLA fuses and
eager PyTorch would run as a kernel of its own); then an HBM probe, 8
passes of an elementwise scale over a 512 MB bf16 tensor (each pass reads
and writes it once). Timed by CUDA events, best of 3 runs after one
warm-up. ``torch.matmul`` is the library's matmul (cuBLAS): the tool
measures the library's peak, as the JAX tool measured XLA's.

    python -m sct_gan_tpu_torch.tools.peak_matmul

Prints the JAX tool's two kinds of line with the card's name and power
limit, then one JSON line. ``--sizes`` and ``--copy-mb`` shrink the run
(``--device cpu`` for tests: host-clock numbers).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from ..utils import resolve_device
from .bench import card_or_device, emit, timed_ms

REPS = 3
CHAIN, PASSES = 16, 8       # matmuls a chain; elementwise passes a probe


def best_ms(run, device) -> float:
    """Best of ``REPS`` runs after one warm-up: CUDA events on the card,
    the host clock on the CPU."""
    run()
    times = [timed_ms(run, device) for _ in range(REPS)]
    return min(t[1] if t[0] is None else t[0] for t in times)


def matmul_chain(n: int, chain: int, device) -> Dict[str, float]:
    """ms and TFLOP/s of ``chain`` dependent (n, n) bf16 matmuls."""
    a = torch.full((n, n), 1e-4, dtype=torch.bfloat16, device=device)
    x0 = torch.ones((n, n), dtype=torch.bfloat16, device=device)

    box = [x0]

    def run():
        x = x0
        for _ in range(chain):
            x = torch.matmul(x, a)
        box[0] = x
    ms = best_ms(run, device)
    if not torch.isfinite(box[0]).all():
        raise AssertionError(f"matmul chain at n={n}: not finite")
    flops = 2.0 * n ** 3 * chain
    return {"n": n, "chain": chain, "ms": ms,
            "tflops_bf16": flops / ms / 1e9}


def hbm_probe(mb: int, passes: int, device) -> Dict[str, float]:
    """ms and GB/s of ``passes`` elementwise scales of an ``mb`` MB bf16
    tensor, each reading and writing it once."""
    m = torch.ones((mb, 512, 1024), dtype=torch.bfloat16, device=device)

    def run():
        x = m
        for _ in range(passes):
            x = x * 1.0000001
    ms = best_ms(run, device)
    nbytes = 2 * m.numel() * m.element_size() * passes
    return {"mb": mb, "passes": passes, "ms": ms,
            "gb_per_s": nbytes / ms / 1e6}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", type=int, nargs="+", default=[4096, 8192])
    ap.add_argument("--copy-mb", type=int, default=512)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_or_device(device)
    res = {"card": card, "device": str(device), "matmul": []}
    for n in args.sizes:
        r = matmul_chain(n, CHAIN, device)
        res["matmul"].append(r)
        print(f"matmul {n}^3 x{CHAIN}: {r['ms']:.2f} ms total -> "
              f"{r['tflops_bf16']:.1f} TFLOPS bf16 [{card}]", flush=True)
    res["hbm"] = hbm_probe(args.copy_mb, PASSES, device)
    print(f"elementwise x{PASSES} over {args.copy_mb} MB: "
          f"{res['hbm']['ms']:.2f} ms -> {res['hbm']['gb_per_s']:.0f} GB/s "
          f"HBM [{card}]", flush=True)
    emit(res, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
