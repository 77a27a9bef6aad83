"""Price the single-pass softmax's parts on the card (K8).

Port of ``tools/time_flash_variants.py`` (its TPU kernel, the
``pallas_call`` at ``:75``). One CUDA kernel (``csrc/flash_variants.cu``)
that, like the TPU's nk == 1 kernel, takes each row's max over all S keys
before any exponent, rescales nothing and computes Q K^T and P V once: the
keys of a query tile are split over a thread block cluster, each block's
scores held in its accumulators, the row max and the partial outputs
exchanged through distributed shared memory. Modes, at s = 0.1 Q K^T:

  nk1     p = exp(s - m)
  exp2    nk1 with exp2 and log2(e) folded into the scale
  mxsum   exp2, with the row sum from the tensor core (P times ones)
  bf16p   exp2 of bf16(s - m), two at a time
  masked  nk1 + p = where(s > -1e29, p, 0)
  mmonly  Q K^T and P V alone

q = k = v = x, (B, H, S, D) bf16 (the tool calls ``f(x, x, x, ones)``; the
kernel's ones are a constant operand). ``time_modes`` times each mode as a
chain of dependent calls ``x = f(x)`` replayed from a CUDA graph
(``chain_ms``), beside its plain version, the library call for the same
function (timed the same way) and its bound.

    python3 -m sct_gan_tpu_torch.tools.time_flash_variants

It measures the card and raises without one.
"""
from __future__ import annotations

import argparse
import math
from typing import Dict

import torch

from ..utils.profiling import (bound_ms, card_line, chain_ms, cuda_ms,
                               require_card)
from ._common import (device_kind, launch_self_attention, mode_index,
                      self_attention_library, summary_line, timing_row)
from .time_flash_parts import DH, HEAD_DIMS, SCALE, SHAPE

MODES = ("nk1", "exp2", "mxsum", "bf16p", "masked", "mmonly")
CHAIN = 200                     # the tool's chain length
MAX_SEQ = 1536                  # twelve blocks of 128 keys in a cluster
LIBRARY = {"nk1": "sdpa", "exp2": "sdpa", "mxsum": "sdpa", "bf16p": "sdpa",
           "masked": "sdpa_mask", "mmonly": "bmm"}
_EXP2 = ("exp2", "mxsum", "bf16p")


def flash_variants_reference(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel, the tool's body
    (``tools/time_flash_variants.py:45-72``) in f32 with P rounded to x's
    dtype before P V."""
    mode_index(mode, MODES)
    xf = x.float()
    scale = SCALE * (math.log2(math.e) if mode in _EXP2 else 1.0)
    s = torch.matmul(xf, xf.transpose(-1, -2)) * scale
    if mode == "mmonly":
        return torch.matmul(s.to(x.dtype).float(), xf).to(x.dtype)
    m = s.amax(dim=-1, keepdim=True)
    if mode == "bf16p":
        p = torch.exp2((s - m).to(torch.bfloat16)).float()
    elif mode in _EXP2:
        p = torch.exp2(s - m)
    else:
        p = torch.exp(s - m)
    if mode == "masked":
        p = torch.where(s > -1e29, p, 0.0)
    pv = p.to(x.dtype).float()
    l = (pv if mode == "mxsum" else p).sum(dim=-1, keepdim=True)
    return (torch.matmul(pv, xf) / l.clamp_min(1e-9)).to(x.dtype)


def flash_variants(x: torch.Tensor, mode: str) -> torch.Tensor:
    """One mode of the K8 kernel on q = k = v = x, (B, H, S, D).

    A CPU tensor runs the plain version; a CUDA tensor the kernel, which
    takes contiguous bf16 with D in (96, 128) and S a multiple of 64 up to
    1536, and raises on anything else."""
    idx = mode_index(mode, MODES)
    if device_kind(x, "flash_variants") == "cpu":
        return flash_variants_reference(x, mode)
    out = launch_self_attention("flash_variants_bf16", x, idx, SCALE,
                                HEAD_DIMS, MAX_SEQ)
    flash_variants.launches += 1
    return out


# Plain count of kernel launches: a run reads it to show it went through the
# kernel. Only a successful launch adds to it.
flash_variants.launches = 0


def time_modes() -> Dict[str, dict]:
    """Each mode's device ms per call (``CHAIN`` dependent calls, the best
    of three replays), its plain version's and the library call's ms, and
    the bound, at the tool's shape and the model's head (D = 96) with the
    tool's input, x = 0.01 everywhere."""
    dev = require_card()
    b, h, s = SHAPE
    x0 = torch.full((b, h, s, DH), 0.01, dtype=torch.bfloat16, device=dev)
    bound = bound_ms(4 * b * h * s * s * DH,
                     2 * x0.numel() * x0.element_size())
    out: Dict[str, dict] = {}
    with torch.inference_mode():
        libs = {kind: chain_ms(self_attention_library(kind, SCALE), x0, CHAIN)
                for kind in sorted(set(LIBRARY.values()))}
        for mode in MODES:
            out[mode] = timing_row(
                chain_ms(lambda x, m=mode: flash_variants(x, m), x0, CHAIN),
                cuda_ms(lambda m=mode: flash_variants_reference(x0, m),
                        iters=3, warmup=1),
                libs[LIBRARY[mode]], bound)
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    result = time_modes()
    print(summary_line(f"time_flash_variants {SHAPE + (DH,)} bf16, chain "
                       f"{CHAIN}", result, card_line()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
