"""Sweep the flash-attention backward pair's tile shapes on the card.

Port of ``tools/sweep_flash_blocks.py``, which times the Pallas kernel's
(block_q, block_k) pairs at (8, 8, 1024, 128) with dropout 0.3 and a causal
mask, beside the dense reference. On the card a tile shape is a template
argument, so the candidates are compiled:
``csrc/sweep/flash_bwd_sweep.cu`` instantiates every candidate shape of the
dKV and dQ kernels of ``csrc/flash_bwd_hopper.cuh`` at one head dim (the
shipped shape, ``Shipped<D>``, among them) into a library of its own,
built when the tool runs. A dKV shape is (keys a block, ring stages, blocks
an SM asked of the register allocator), a dQ shape (ring stages, blocks an
SM asked; 64 queries a block).

At (8, 8, 1024, d) for each head dim, every key attended (the JAX tool's
all-True mask), dropout 0.3, causal and not, it times each candidate's
kernel alone (``ring_ms``: calls round inputs twice the L2, so each reads
HBM; D = rowsum(dO ∘ O) computed beforehand by the shipped entry point),
the shipped pair through ``flash_attention_backward`` (its D kernel
included) and SDPA's backward (its forward and backward less its
forward), and prints one table a head dim: each shape's registers and
spills (``ptxas -v``), shared memory, resident blocks an SM and times, the
shipped shape marked. Every candidate of a kernel sums its tiles in the
same order, so each must give the shipped candidate's gradients bit for
bit; the tool raises when one does not.

    python3 -m sct_gan_tpu_torch.tools.sweep_flash_blocks [--head-dims 96]

It measures the card and raises without one.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
from typing import Dict, List, Optional, Sequence

import torch

from ..ops import _build
from ..utils.profiling import card_line, require_card, ring_inputs, ring_ms
from ._common import sdpa_backward_ms

HEAD_DIMS = (64, 96, 128)
SHAPE = (8, 8, 1024)            # the JAX tool's (B, H, L)
RATE = 0.3                      # the JAX tool's dropout
SEED = 0
PARTS = ("dkv", "dq")
CALLS = 10                      # calls a timed replay
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "sweep", "flash_bwd_sweep.cu")
_I, _P = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "flash_bwd_sweep_count": [_I],
    "flash_bwd_sweep_shape": [_I, _I, _P],
    "flash_bwd_sweep_bf16": [_I, _I, *_build._SIGNATURES[
        "flash_attention_bwd_bf16"]],
}
# a kernel's template argument in a mangled name: DkvShapeILi96ELi2ELi3ELi1EE
_SHAPE_ARG = re.compile(r"(Dkv|Dq)ShapeI((?:Li\d+E)+)E")


def build(d: int):
    """(library, ``ptxas -v`` report) of the candidates at head dim ``d``;
    built on first use, cached as the main library is."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the sweep has {HEAD_DIMS}")
    path, log, _ = _build.build_library([SOURCE], f"sct_sweep_dh{d}",
                                        [f"-DSWEEP_D={d}"])
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, log


def ptxas_shapes(log: str) -> Dict[tuple, dict]:
    """(part, shape numbers) -> registers and spill bytes, from the ``ptxas
    -v`` report of a sweep library (or of the main library: its shipped
    instances)."""
    out: Dict[tuple, dict] = {}
    key = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = _SHAPE_ARG.search(ln)
            key = None if m is None else (
                "dkv" if m.group(1) == "Dkv" else "dq",
                tuple(int(x) for x in re.findall(r"Li(\d+)E", m.group(2))))
            if key is not None:
                out[key] = {"registers": None, "spill_bytes": 0}
        elif key is not None and "registers" in ln:
            out[key]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  ln).group(1))
        elif key is not None and "spill" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            out[key]["spill_bytes"] = sum(nums[1:])
    return out


def candidates(lib, d: int, log: str) -> List[dict]:
    """Every candidate of both kernels: its shape, whether it ships, the
    blocks an SM that fit (registers and shared memory), its shared memory
    and its ``ptxas`` report."""
    regs = ptxas_shapes(log)
    out = []
    for p, part in enumerate(PARTS):
        for i in range(lib.flash_bwd_sweep_count(p)):
            v = (ctypes.c_int * 6)()
            _build.check(lib.flash_bwd_sweep_shape(p, i, v),
                         "flash_bwd_sweep_shape")
            rows, stages, minb, shipped, resident, smem = list(v)
            numbers = ((d, rows // 64, stages, minb) if part == "dkv"
                       else (d, stages, minb))
            out.append({"part": part, "index": i, "rows": rows,
                        "stages": stages, "min_blocks": minb,
                        "shipped": bool(shipped), "blocks_per_sm": resident,
                        "smem_bytes": smem,
                        **regs.get((part, numbers),
                                   {"registers": None, "spill_bytes": None})})
    return out


def _inputs(d: int, dev, causal: bool):
    """q, k, v, the forward's out and lse, dO and D at (8, 8, 1024, d):
    the model's head views of (B, L, 8 d), seed 0."""
    from ..ops.flash_attention import backward_call, flash_attention
    b, h, s = SHAPE
    g = torch.Generator(device=dev).manual_seed(0)

    def heads():
        return torch.randn(b, s, h * d, generator=g, device=dev).to(
            torch.bfloat16).view(b, s, h, d).transpose(1, 2)
    q, k, v, dout = heads(), heads(), heads(), heads()
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    with torch.no_grad():
        out, lse = flash_attention(q, k, v, key_padding_mask=mask,
                                   causal=causal, sm_scale=d ** -0.5,
                                   dropout_rate=RATE, seed=SEED,
                                   return_lse=True)
    # D as the shipped entry point computes it (one run of it), so that the
    # candidates can be held to the shipped pair bit for bit
    args, _, (_, dvec) = backward_call(q, k, v, out, lse, dout, mask, causal,
                                       d ** -0.5, RATE, SEED)
    _build.check(_build.load().flash_attention_bwd_bf16(*args),
                 "flash_attention_bwd_bf16")
    return (q, k, v, out, lse, dout, dvec), mask


def run_candidate(lib, c: dict, x: Sequence[torch.Tensor], mask,
                  causal: bool):
    """One candidate's kernel on ``x`` = (q, k, v, out, lse, dO, D): its
    gradients (dK and dV from a dKV candidate, dQ from a dQ candidate)."""
    from ..ops.flash_attention import backward_call
    q, k, v, out, lse, dout, dvec = x
    args, (dq, dk, dv), _keep = backward_call(
        q, k, v, out, lse, dout, mask, causal, q.shape[-1] ** -0.5, RATE,
        SEED, dvec=dvec)
    _build.check(lib.flash_bwd_sweep_bf16(PARTS.index(c["part"]), c["index"],
                                          *args), "flash_bwd_sweep_bf16")
    return (dk, dv) if c["part"] == "dkv" else (dq,)


def _same_bits(a, b) -> bool:
    return all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               for x, y in zip(a, b))


def sweep(d: int, modes: Sequence[bool] = (False, True)) -> dict:
    """Time every candidate at head dim ``d`` under each causal mode in
    ``modes``, the shipped pair and SDPA's backward. Returns the candidates
    (``ms`` and ``ms_causal`` added), ``pair`` and ``sdpa`` (ms by mode)."""
    from ..ops.flash_attention import flash_attention_backward
    dev = require_card()
    lib, log = build(d)
    cands = candidates(lib, d, log)
    result = {"head_dim": d, "shape": (*SHAPE, d), "candidates": cands,
              "pair": {}, "sdpa": {}}
    for causal in modes:
        key = "ms_causal" if causal else "ms"
        x, mask = _inputs(d, dev, causal)
        got = [run_candidate(lib, c, x, mask, causal) for c in cands]
        want = {c["part"]: g for c, g in zip(cands, got) if c["shipped"]}
        for c, g in zip(cands, got):  # bit for bit the shipped candidate's
            if not _same_bits(g, want[c["part"]]):
                raise AssertionError(f"sweep d={d} causal={causal}: "
                                     f"candidate {c} differs from the "
                                     f"shipped {c['part']} kernel")
        del got
        dq, dk, dv = flash_attention_backward(
            x[0], x[1], x[2], x[3], x[4], x[5], mask, causal, d ** -0.5,
            RATE, SEED)
        if not (_same_bits((dk, dv), want["dkv"])
                and _same_bits((dq,), want["dq"])):
            raise AssertionError(f"sweep d={d}: the shipped pair differs "
                                 f"from its candidates")
        ring = ring_inputs(x)
        for c in cands:
            c[key] = ring_ms(lambda a, c=c: run_candidate(lib, c, a, mask,
                                                          causal), ring, CALLS)
        result["pair"][key] = ring_ms(
            lambda a: flash_attention_backward(a[0], a[1], a[2], a[3], a[4],
                                               a[5], mask, causal, d ** -0.5,
                                               RATE, SEED), ring, CALLS)
        del ring
        result["sdpa"][key] = sdpa_backward_ms(
            x[0], x[1], x[2], None if causal else mask, x[5], d ** -0.5,
            causal=causal)
    return result


def table(result: dict, card: str) -> str:
    """A sweep's result as a table: one line a candidate, then the best of
    each kernel, the shipped pair and SDPA."""
    keys = [k for k in ("ms", "ms_causal") if k in result["pair"]]
    title = {"ms": "ms", "ms_causal": "ms causal"}
    lines = [f"sweep_flash_blocks {result['shape']} bf16, dropout {RATE}, "
             f"every key attended, {CALLS} calls a replay [{card}]:"]
    for c in result["candidates"]:
        what = (f"{c['rows']:3d} keys" if c["part"] == "dkv"
                else " 64 queries")
        regs = "?" if c["registers"] is None else c["registers"]
        lines.append(
            f"  {c['part']:3s} {what}, {c['stages']} stages, "
            f"{c['min_blocks']} asked: {regs} registers, spill "
            f"{c['spill_bytes']} B, {c['smem_bytes'] / 1024:.1f} KB, "
            f"{c['blocks_per_sm']} blocks/SM | "
            + ", ".join(f"{title[k]} {c[k]:.4f}" for k in keys)
            + ("  <- shipped" if c["shipped"] else ""))
    for k in keys:
        best = {p: min((c for c in result["candidates"] if c["part"] == p),
                       key=lambda c: c[k]) for p in PARTS}
        lines.append(
            f"  {title[k]}: best dkv {best['dkv'][k]:.4f} (index "
            f"{best['dkv']['index']}) + best dq {best['dq'][k]:.4f} (index "
            f"{best['dq']['index']}) = {best['dkv'][k] + best['dq'][k]:.4f}; "
            f"shipped pair with D {result['pair'][k]:.4f}; SDPA backward "
            f"{result['sdpa'][k]:.4f}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--head-dims", type=int, nargs="+",
                    default=list(HEAD_DIMS), choices=HEAD_DIMS)
    args = ap.parse_args(argv)
    require_card()
    card = card_line()
    for d in args.head_dims:
        print(table(sweep(d), card), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
