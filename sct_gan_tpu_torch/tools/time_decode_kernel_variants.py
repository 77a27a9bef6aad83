"""Time the decode attention's blocking on the card: split over the keys of
each (b, h), per b, or over an (H*S) slab (K9).

Port of ``tools/time_decode_kernel_variants.py`` (its TPU kernels, the
``pallas_call``s at ``:77``, v2, and ``:113``, v3):

  v1  the shipped kernel K5 (``csrc/decode_attention.cu``): split-K over
      the keys, up to 8 blocks per (b, h) (one block at this tool's B=32),
      combined inside the launch through a thread block cluster
  v2  one block per batch row walking the heads, each head's K then its V
      streamed by TMA through the cache's strides (dead 64-key tiles
      skipped)
  v3  one block per batch row reading K and V as its (H*S, dh) slab, in
      linear bulk copies of 128 rows that straddle heads

v2 and v3 are one CUDA kernel file (``csrc/decode_variants.cu``), with
instances at dh 64, 96 and 128. As in the tool, v2 and v3 must first agree
with v1 within 2e-2, then each is timed as ``n`` dependent decode calls
(``q = q + o * 0``) replayed from a CUDA graph (``chain_ms``), beside the
plain version, SDPA with the key mask in the same loop, and the floor: the
K and V rows of the attended keys read once (with q and the mask, and o
written) at the card's 3.35 TB/s. Each mode's rate is also given per block
of a batch row (``per_sm_gbs``: those bytes over its time, over B): v2 and
v3 run B blocks, so B SMs must pull every byte.

    python3 -m sct_gan_tpu_torch.tools.time_decode_kernel_variants [--batch 32] [--steps 256] [--dh 96]

It measures the card and raises without one.
"""
from __future__ import annotations

import argparse
import ctypes
from typing import Dict, Optional

import torch

from ..ops import _build
from ..ops.decode_attention import decode_attention, decode_attention_reference
from ..ops.flash_attention import _mask_arg, _strides
from ..utils.profiling import (bound_ms, card_line, chain_ms, cuda_ms,
                               require_card)
from ._common import device_kind, mode_index, summary_line, timing_row

MODES = ("v1", "v2", "v3")
PARITY_TOL = 2e-2               # the tool's gate: v2, v3 against v1, max abs
MAX_KEYS = 8192                 # v2: one head's scores in shared memory
MAX_SLAB_KEYS = 4096            # v3: a head and the rows in flight behind it
HEAD_DIMS = (64, 96, 128)       # v2, v3: the head dims of the kernel's instances


def decode_variants_reference(q, k, v, mask=None, *, sm_scale: float):
    """Plain PyTorch version (every mode computes the same function)."""
    return decode_attention_reference(q, k, v, mask, sm_scale=sm_scale)


def kernel_shape(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mode: str):
    """(B, H, S, dh) of a v2 or v3 call, checked against what the kernel
    takes: one query row, K and V alike, dh in ``HEAD_DIMS``, 1 to 8192
    keys (v2) or 4096 (v3). Raises ValueError on anything else; reads only
    the shapes, so it holds for tensors on any device."""
    b, h, sq, d = q.shape
    s = k.shape[2]
    if sq != 1 or k.shape != (b, h, s, d) or v.shape != (b, h, s, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    limit = MAX_SLAB_KEYS if mode == "v3" else MAX_KEYS
    if d not in HEAD_DIMS or not 0 < s <= limit:
        raise ValueError(f"head dim {d} / keys {s} not supported (head dims "
                         f"{HEAD_DIMS}, 1..{limit} keys)")
    return b, h, s, d


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, H, S, dh) as v2's TMA maps read it: last dim contiguous,
    base and strides on 16-byte lines (a copy when it is not)."""
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(x % 8 == 0 for x in t.stride()[:3])):
        return t
    return t.contiguous()


def _slab(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, H, S, dh) whose batch rows are dense (H*S, dh) slabs on
    16-byte lines, as v3 reads them (a copy when they are not)."""
    b, h, s, d = t.shape
    dense = (t.stride(3) == 1 and t.stride(2) == d and t.stride(1) == s * d
             and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0)
    return t if dense else t.contiguous()


def decode_variants(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, mode: str = "v2", *,
                    sm_scale: float) -> torch.Tensor:
    """One decode-attention variant: q (B, H, 1, dh), k and v (B, H, S, dh),
    mask (B, S) bool (True = attend) or None; returns (B, H, 1, dh).

    A CPU tensor runs the plain version. On CUDA, v1 is K5
    (``ops.decode_attention``, which counts its own launches); v2 and v3
    launch this tool's kernel: bf16, dh in ``HEAD_DIMS``, up to
    ``MAX_KEYS`` / ``MAX_SLAB_KEYS`` keys (``kernel_shape``); anything else
    raises. K and V that the kernel cannot read in place (v2: strides off
    16-byte lines; v3: batch rows that are not dense slabs) are copied."""
    idx = mode_index(mode, MODES)
    if device_kind(q, "decode_variants") == "cpu":
        return decode_variants_reference(q, k, v, mask, sm_scale=sm_scale)
    if mode == "v1":
        return decode_attention(q, k, v, mask, sm_scale=sm_scale)
    b, h, s, d = kernel_shape(q, k, v, mode)
    qs = _strides(q, "q", 4)
    operand = _slab if mode == "v3" else _tma_operand
    k, v = operand(k), operand(v)
    ks, vs = _strides(k, "k", 16), _strides(v, "v", 16)
    if mode == "v3":                            # slab rows dh apart; no sh
        ks, vs = (ks[0], 0, d), (vs[0], 0, d)
    out = torch.empty(b, h, 1, d, dtype=q.dtype, device=q.device)
    os_ = _strides(out, "out", 4)
    mptr, msb, _keep = _mask_arg(mask, b, s, q.device)
    err = _build.load().decode_variants_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mptr, out.data_ptr(),
        idx + 1, b, h, s, d, qs[0], qs[1], *ks, *vs, os_[0], os_[1], msb,
        ctypes.c_float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_variants_bf16")
    decode_variants.launches += 1
    return out


# Plain count of the v2/v3 kernel's launches (v1 counts on K5's wrapper): a
# run reads it to show it went through the kernel. Only a launch adds to it.
decode_variants.launches = 0


def make_inputs(batch: int, heads: int, seq: int, dh: int, seed: int,
                device):
    """The tool's inputs: q, K, V standard normal in bf16, a key mask with
    about 10% of keys off."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device).to(
            torch.bfloat16)
    q, k, v = rnd(batch, heads, 1, dh), rnd(batch, heads, seq, dh), rnd(
        batch, heads, seq, dh)
    mask = torch.rand(batch, seq, generator=g, device=device) > 0.1
    return q, k, v, mask


def time_modes(batch: int = 32, steps: int = 256, seq: int = 1024,
               dh: int = 96, heads: int = 8) -> Dict[str, dict]:
    """The tool's parity gate (v2, v3 within 2e-2 of v1, else it raises),
    then each mode's device ms per call over ``steps`` dependent calls (the
    best of three replays), the plain version's and SDPA's ms, and the
    bound, which counts the K and V rows of attended keys only: no mode
    reads a masked key's row."""
    dev = require_card()
    q, k, v, mask = make_inputs(batch, heads, seq, dh, 0, dev)
    scale = dh ** -0.5
    with torch.inference_mode():
        want = decode_variants(q, k, v, mask, "v1", sm_scale=scale).float()
        for mode in ("v2", "v3"):
            got = decode_variants(q, k, v, mask, mode, sm_scale=scale)
            err = (got.float() - want).abs().max().item()
            if not err < PARITY_TOL:
                raise AssertionError(f"{mode} parity max-abs-err vs v1: "
                                     f"{err} (gate {PARITY_TOL})")
        rows = int(mask.sum().item()) * heads      # attended (b, h, key) rows
        nbytes = ((2 * rows * dh + 2 * q.numel()) * q.element_size()
                  + mask.numel())
        bound = bound_ms(4 * rows * dh, nbytes)
        sdpa_mask = mask[:, None, None, :]
        lib = chain_ms(lambda x: x + torch.nn.functional.
                       scaled_dot_product_attention(
                           x, k, v, attn_mask=sdpa_mask, scale=scale) * 0,
                       q, steps)
        plain = cuda_ms(lambda: decode_variants_reference(
            q, k, v, mask, sm_scale=scale), iters=20)
        out: Dict[str, dict] = {}
        for mode in MODES:
            out[mode] = timing_row(chain_ms(
                lambda x, m=mode: x + decode_variants(
                    x, k, v, mask, m, sm_scale=scale) * 0, q, steps),
                plain, lib, bound)
            out[mode]["per_sm_gbs"] = per_sm_gbs(nbytes, out[mode]["ms"],
                                                 batch)
    return out


def per_sm_gbs(nbytes: float, ms: float, batch: int) -> float:
    """GB/s a block of a batch row pulls: ``nbytes`` over ``ms``, over the
    ``batch`` blocks that v2 and v3 run (one an SM)."""
    return nbytes / (ms * 1e-3) / batch / 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--dh", type=int, default=96)
    ap.add_argument("--heads", type=int, default=8)
    args = ap.parse_args(argv)
    result = time_modes(args.batch, args.steps, args.seq, args.dh,
                        args.heads)
    print(summary_line(
        f"time_decode_kernel_variants ({args.batch}, {args.heads}, "
        f"{args.seq}, {args.dh}) bf16, {args.steps} steps", result,
        card_line()), flush=True)
    floor = result["v1"]["bound_ms"]
    for mode, r in result.items():
        print(f"  {mode}: {r['ms'] / floor:.2f}x the floor "
              f"({floor:.4f} ms), {r['per_sm_gbs']:.1f} GB/s a batch row's "
              f"block", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
