"""Price the dropout kernel's random draw against a copy on the card (K10).

Port of ``tools/time_dropout_kernel.py`` (its TPU kernel, the
``pallas_call`` at ``:76``). One CUDA kernel (``csrc/dropout_variants.cu``),
the same grid and loads in every mode, over an (N, C) bf16 tensor:

  copy   x * 1.0001 (rounded to bf16): read and write only
  drop   one 32-bit draw per element: K6's formula (``ops/dropout.py``)
  byte4  one draw per 4 elements: element (r, c) takes byte c // (C/4) of
         word (r, c % (C/4)), kept iff >= int(rate * 256)
  half2  one draw per 2 elements: half c // (C/2) of word (r, c % (C/2)),
         kept iff >= int(rate * 65536)

The TPU tool drew its words from the TPU's own PRNG; a word here is the JAX
package's murmur3 hash of its flat word index plus the seed, as K6's
elements are, so the JAX package reproduces every mode bit for bit.
``time_modes`` times each mode as ``CHAIN`` calls replayed from a CUDA
graph, beside the plain version, ``x.mul`` (copy) or ``F.dropout`` (the
draws), timed the same way, and the bound: one read and one write of x at
the HBM rate. The TPU tool chained ``x = f(x)``; here the calls go round a
ring of inputs larger than the L2 (``ring_ms``), because a chained 12.6 MB
x and its output stay in the 50 MB L2 and would run under that bound.

    python3 -m sct_gan_tpu_torch.tools.time_dropout_kernel

It measures the card and raises without one.
"""
from __future__ import annotations

import argparse
import ctypes
from typing import Dict, Tuple

import torch

from ..ops import _build
from ..ops.dropout import dropout_reference, hash_bits, keep_threshold
from ..utils.profiling import (bound_ms, card_line, cuda_ms, require_card,
                               ring_inputs, ring_ms)
from ._common import device_kind, mode_index, summary_line, timing_row

MODES = ("copy", "drop", "byte4", "half2")
SHAPE = (8 * 1024, 768)         # the tool's (N, C)
RATE = 0.1                      # the tool's rate
CHAIN = 300                     # the tool's chain length: calls timed
COPY_FACTOR = 1.0001            # the tool's copy multiplier, before rounding
_WIDTH = {"byte4": 4, "half2": 2}   # elements sharing one 32-bit draw


def _constants(mode: str, rate: float, dtype) -> Tuple[float, int]:
    """(the multiplier of a kept element in x's dtype, the keep threshold of
    the mode's draw width), as the tool computes them."""
    if mode == "copy":
        return float(torch.tensor(COPY_FACTOR, dtype=dtype)), 0
    scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
                  .to(dtype))
    if mode == "drop":
        return scale, keep_threshold(rate)
    return scale, int(rate * 2.0 ** (32 // _WIDTH[mode]))


def dropout_variants_reference(x: torch.Tensor, mode: str, rate: float = RATE,
                               seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel, the tool's body
    (``tools/time_dropout_kernel.py:47-73``) with the hash for its PRNG."""
    mode_index(mode, MODES)
    scale, thr = _constants(mode, rate, x.dtype)
    if mode == "copy":
        return x * torch.tensor(scale, dtype=x.dtype, device=x.device)
    if mode == "drop":
        return dropout_reference(x, seed, rate)
    n, c = x.shape
    width = _WIDTH[mode]
    bits = 32 // width
    words = hash_bits(n * (c // width), seed, x.device).view(n, c // width)
    field = torch.cat([(words >> (bits * i)) & (2 ** bits - 1)
                       for i in range(width)], dim=1)
    mult = torch.where(field >= thr, scale, 0.0).to(x.dtype)
    return x * mult


def dropout_variants(x: torch.Tensor, mode: str, rate: float = RATE,
                     seed: int = 0) -> torch.Tensor:
    """One mode of the K10 kernel on x, (N, C).

    A CPU tensor runs the plain version; a CUDA tensor the kernel, which
    takes contiguous bf16 with C a multiple of 32 and N*C < 2^31, and raises
    on anything else."""
    idx = mode_index(mode, MODES)
    if not 0.0 < rate < 1.0:
        raise ValueError(f"rate {rate}: expected 0 < rate < 1")
    if device_kind(x, "dropout_variants") == "cpu":
        return dropout_variants_reference(x, mode, rate, seed)
    if (x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous()
            or x.shape[1] % 32 or x.numel() >= 2 ** 31):
        raise ValueError(f"dropout_variants: expected a contiguous bf16 "
                         f"(N, C) tensor, C a multiple of 32, N*C < 2^31; "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.data_ptr() % 16:
        x = x.clone()                   # the kernel reads 16 bytes a thread
    scale, thr = _constants(mode, rate, x.dtype)
    y = torch.empty_like(x)
    err = _build.load().dropout_variants_bf16(
        x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1], idx, seed, thr,
        ctypes.c_float(scale), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dropout_variants_bf16")
    dropout_variants.launches += 1
    return y


# Plain count of kernel launches: a run reads it to show it went through the
# kernel. Only a successful launch adds to it.
dropout_variants.launches = 0


def time_modes() -> Dict[str, dict]:
    """Each mode's device ms per call (``CHAIN`` calls round a ring of
    inputs read from HBM, the best of three replays), its plain version's
    and the library call's ms, and the bound, at the tool's shape on a
    standard-normal bf16 x."""
    import torch.nn.functional as F
    dev = require_card()
    g = torch.Generator(device=dev).manual_seed(0)
    x0 = torch.randn(*SHAPE, generator=g, device=dev).to(torch.bfloat16)
    xs = ring_inputs(x0)
    bound = bound_ms(0, 2 * x0.numel() * x0.element_size())
    copy_scale = _constants("copy", RATE, x0.dtype)[0]
    out: Dict[str, dict] = {}
    with torch.inference_mode():
        libs = {"copy": ring_ms(lambda x: x.mul(copy_scale), xs, CHAIN),
                "draw": ring_ms(lambda x: F.dropout(x, RATE, training=True),
                                xs, CHAIN)}
        for mode in MODES:
            out[mode] = timing_row(
                ring_ms(lambda x, m=mode: dropout_variants(x, m, RATE), xs,
                        CHAIN),
                cuda_ms(lambda m=mode: dropout_variants_reference(x0, m),
                        iters=5, warmup=1),
                libs["copy" if mode == "copy" else "draw"], bound)
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    result = time_modes()
    print(summary_line(f"time_dropout_kernel {SHAPE} bf16 rate {RATE}, "
                       f"{CHAIN} calls from HBM", result, card_line()),
          flush=True)
    nbytes = 2 * SHAPE[0] * SHAPE[1] * 2
    for mode, r in result.items():
        print(f"  {mode}: {nbytes / r['ms'] / 1e6:.0f} GB/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
