"""Take the flash-attention forward apart on the card: products, exponent,
softmax (K7).

Port of ``tools/time_flash_parts.py`` (its TPU kernel, the ``pallas_call``
at ``:81``). One CUDA kernel (``csrc/flash_parts.cu``): the shipped flash
forward's (K1's) Hopper pipeline at head dims 96 and 128, the TMA producer
and the two ping-pong ``wgmma`` consumers of ``csrc/flash_fwd_hopper.cuh``,
with one of three elementwise bodies between the two products, so that the
grid, the loads and the products are the same in all three:

  full    the online softmax: running max and sum, the accumulator rescaled
  noexp   p = clip(s, 0, 1): no max, no exponent, no rescale
  mmonly  Q K^T and P V alone

with s = 0.1 Q K^T and q = k = v = x, (B, H, S, D) bf16 (the tool calls
``f(x, x, x)``). ``time_modes`` times each mode as a chain of dependent
calls ``x = f(x)`` replayed from a CUDA graph (``chain_ms``), beside its
plain version, the PyTorch library call for the same function (timed the
same way) and its bound, and times K1, the shipped forward kernel, at the
same shape as a reference row.

    python3 -m sct_gan_tpu_torch.tools.time_flash_parts

It measures the card and raises without one.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from ..utils.profiling import (bound_ms, card_line, chain_ms, cuda_ms,
                               require_card)
from ._common import (device_kind, launch_self_attention, mode_index,
                      self_attention_library, summary_line, timing_row)

MODES = ("full", "noexp", "mmonly")
SCALE = 0.1                     # the tool's score scale
SHAPE = (8, 8, 1024)            # the tool's (B, H, S)
HEAD_DIMS = (96, 128)           # the model's head; the tool's lane-padded one
DH = 96                         # the head time_modes times (128: checks only)
CHAIN = 20                      # the tool's chain length
LIBRARY = {"full": "sdpa", "mmonly": "bmm"}   # noexp: no one PyTorch call


def rising_max(x: torch.Tensor) -> torch.Tensor:
    """``x`` plus ``2 j / S`` on every column of key row ``j``: with q = k =
    v the score maxima then rise along the keys, so ``full`` rescales O at
    most (row, key tile) pairs (86-90% at S = 256-1024 on 0.5 N(0, 1) at
    D = 96; the tool's own input, x = 0.01 everywhere, never moves the
    max). A check input; the tool does not time it."""
    s = x.shape[-2]
    ramp = 2.0 * torch.arange(s, device=x.device, dtype=torch.float32) / s
    return (x.float() + ramp[:, None]).to(x.dtype)


def flash_parts_reference(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 scores and row sums, P
    rounded to x's dtype before P V, ``O = acc / max(l, 1e-9)`` (mmonly:
    ``acc``), as the tool's kernel."""
    mode_index(mode, MODES)
    xf = x.float()
    s = torch.matmul(xf, xf.transpose(-1, -2)) * SCALE
    if mode == "full":
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    elif mode == "noexp":
        p = s.clamp(0.0, 1.0)
    else:
        p = s
    out = torch.matmul(p.to(x.dtype).float(), xf)
    if mode != "mmonly":
        out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return out.to(x.dtype)


def flash_parts(x: torch.Tensor, mode: str) -> torch.Tensor:
    """One mode of the K7 kernel on q = k = v = x, (B, H, S, D).

    A CPU tensor runs the plain version; a CUDA tensor the kernel, which
    takes contiguous bf16 with D in (96, 128) and S a multiple of 64, and
    raises on anything else."""
    idx = mode_index(mode, MODES)
    if device_kind(x, "flash_parts") == "cpu":
        return flash_parts_reference(x, mode)
    out = launch_self_attention("flash_parts_bf16", x, idx, SCALE, HEAD_DIMS)
    flash_parts.launches += 1
    return out


# Plain count of kernel launches: a run reads it to show it went through the
# kernel. Only a successful launch adds to it.
flash_parts.launches = 0


def time_modes() -> Dict[str, dict]:
    """Each mode's device ms per call (``CHAIN`` dependent calls, the best
    of three replays), its plain version's and the library call's ms, and
    the bound; and ``"k1"``, the shipped forward kernel, at the tool's shape
    and the model's head (D = 96) with the tool's input, x = 0.01
    everywhere (values do not change the work)."""
    from ..ops.flash_attention import (flash_attention,
                                       flash_attention_reference)
    dev = require_card()
    b, h, s = SHAPE
    x0 = torch.full((b, h, s, DH), 0.01, dtype=torch.bfloat16, device=dev)
    bound = bound_ms(4 * b * h * s * s * DH,
                     2 * x0.numel() * x0.element_size())
    out: Dict[str, dict] = {}
    with torch.inference_mode():
        for mode in MODES:
            lib: Optional[float] = None
            if mode in LIBRARY:
                lib = chain_ms(self_attention_library(LIBRARY[mode], SCALE),
                               x0, CHAIN)
            out[mode] = timing_row(
                chain_ms(lambda x, m=mode: flash_parts(x, m), x0, CHAIN),
                cuda_ms(lambda m=mode: flash_parts_reference(x0, m), iters=3,
                        warmup=1), lib, bound)
        out["k1"] = timing_row(
            chain_ms(lambda x: flash_attention(x, x, x, sm_scale=SCALE), x0,
                     CHAIN),
            cuda_ms(lambda: flash_attention_reference(
                x0, x0, x0, sm_scale=SCALE), iters=3, warmup=1),
            out["full"]["library_ms"], bound)
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    result = time_modes()
    print(summary_line(f"time_flash_parts {SHAPE + (DH,)} bf16, chain "
                       f"{CHAIN}", result, card_line()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
