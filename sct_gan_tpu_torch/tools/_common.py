"""What the kernel-timing tools share: mode lookup, the q = k = v attention
launch of K7 and K8, and the one-line report of a ``time_modes`` result."""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from ..ops import _build


def mode_index(mode: str, modes: Sequence[str]) -> int:
    if mode not in modes:
        raise ValueError(f"mode {mode!r}: expected one of {tuple(modes)}")
    return modes.index(mode)


def device_kind(x: torch.Tensor, name: str) -> str:
    """``"cpu"`` (plain version) or ``"cuda"`` (kernel); anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got one on "
                         f"{x.device}")
    return x.device.type


def launch_self_attention(fn_name: str, x: torch.Tensor, mode: int,
                          scale: float, head_dims: Sequence[int],
                          max_seq: Optional[int] = None) -> torch.Tensor:
    """Launch a K7/K8 kernel with q = k = v = x: a contiguous bf16 CUDA
    tensor (B, H, S, D), D in ``head_dims``, S a multiple of 64 (at most
    ``max_seq``). Returns the (B, H, S, D) output."""
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{fn_name}: expected a contiguous bf16 (B, H, S, D) "
                         f"tensor, got {x.dtype} {tuple(x.shape)} strides "
                         f"{x.stride()}")
    b, h, s, d = x.shape
    if (d not in head_dims or s <= 0 or s % 64
            or (max_seq is not None and s > max_seq)):
        raise ValueError(f"{fn_name}: head dim {d} / keys {s} not supported "
                         f"(head dims {tuple(head_dims)}; keys a multiple of "
                         f"64{'' if max_seq is None else f' up to {max_seq}'})")
    if x.data_ptr() % 16:
        x = x.clone()                   # the kernels read 16 bytes a thread
    out = torch.empty_like(x)
    ptr = x.data_ptr()
    err = getattr(_build.load(), fn_name)(
        ptr, ptr, ptr, out.data_ptr(), b * h, s, d, mode,
        ctypes.c_float(scale), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, fn_name)
    return out


def self_attention_library(kind: str, scale: float):
    """A step ``x -> f(x)`` by a PyTorch library call computing a K7/K8
    mode's function of x (q = k = v), timed beside the kernel as a chain;
    the port never calls it.

    ``"sdpa"``: softmax attention; ``"sdpa_mask"``: the same through SDPA's
    key-mask path (an all-True mask); ``"bmm"``: the products alone,
    ``(scale x x^T) x`` by ``baddbmm`` (beta 0, so its input is not read)
    and ``bmm``."""
    import torch.nn.functional as F
    if kind == "sdpa":
        return lambda x: F.scaled_dot_product_attention(x, x, x, scale=scale)
    if kind == "sdpa_mask":
        def masked(x):
            b, _, s, _ = x.shape
            mask = torch.ones(b, 1, 1, s, dtype=torch.bool, device=x.device)
            return F.scaled_dot_product_attention(x, x, x, attn_mask=mask,
                                                  scale=scale)
        return masked
    if kind == "bmm":
        def products(x):
            b, h, s, d = x.shape
            x3 = x.reshape(b * h, s, d)
            zero = torch.zeros(1, 1, 1, dtype=x.dtype, device=x.device)
            return torch.bmm(torch.baddbmm(zero, x3, x3.transpose(1, 2),
                                           beta=0.0, alpha=scale),
                             x3).view(b, h, s, d)
        return products
    raise ValueError(f"library call {kind!r}")


def timing_row(ms: float, plain_ms: float, library_ms: Optional[float],
               bound: tuple) -> Dict[str, object]:
    """One mode's times: the kernel, its plain version, the library call
    (None where no one PyTorch call computes the function) and the bound."""
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound[0], "bound_by": bound[1]}


def summary_line(title: str, result: Dict[str, dict], card: str) -> str:
    """``time_modes``'s result as one line, with the card it ran on."""
    parts = []
    for mode, r in result.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        parts.append(f"{mode} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                     f"library {lib}, bound {r['bound_ms']:.4f} "
                     f"{r['bound_by']})")
    return f"{title} [{card}]: " + "; ".join(parts)
