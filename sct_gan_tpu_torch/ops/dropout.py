"""Hash dropout: the hand-written CUDA kernel (K6) and its plain version.

Counterpart of ``sct_gan_tpu/ops/dropout.py``: ``fast_dropout`` semantics
with the JAX package's default mask stream (``_hash_dropout``). The keep
mask is a murmur3 finaliser of the flat element index plus a 32-bit seed,
keep iff ``h >= uint32(min(rate, 0.999999) * 2**32)``; kept values are
scaled by ``1 / (1 - rate)`` rounded to x's dtype. The backward regenerates
the mask from the seed and applies the same function to the gradient.

The TPU kernel ``_dropout2d`` drew its mask from the TPU's PRNG; the kernel
here (``csrc/dropout.cu``) draws the hash stream, so the port reproduces the
JAX package's masks bit for bit on any device. ``dropout`` takes the plain
version for a tensor on the CPU and launches the kernel for a CUDA tensor,
raising on what the kernel does not take.

Under a mesh a rank holds a shard of the tensor the single-card step would
drop, and its mask must be that tensor's mask at the shard's place (the
JAX package's masks do not depend on the sharding: GSPMD keys them on the
global index). ``origin`` is the global flat index of the shard's first
element; ``row_len``, for a shard cut along the last axis (the FFN hidden
under mp), is the global length of that axis, the shard's column origin
being folded into ``origin``. Local element ``i`` of a last axis of ``n``
then has the global index ``origin + (i // n) * row_len + i % n``.
"""
from __future__ import annotations

import math

import torch

from . import _build

_MASK32 = 0xFFFFFFFF
SEED_HIGH = 2 ** 31 - 1   # seeds are drawn from [0, SEED_HIGH), as JAX does


def keep_threshold(rate: float) -> int:
    """The uint32 threshold at or above which a hash keeps its element."""
    return int(min(rate, 0.999999) * 4294967296.0)


def hash_bits(n: int, seed: int, device=None) -> torch.Tensor:
    """The 32 hash bits of flat indices 0..n-1 (int64 holding uint32): the
    murmur3 finaliser of ``_hash_keep`` in the JAX package."""
    return hash_bits_at(torch.arange(n, dtype=torch.int64, device=device),
                        seed)


def hash_bits_at(index: torch.Tensor, seed: int) -> torch.Tensor:
    """The 32 hash bits of the int64 flat indices ``index``.

    torch has no full uint32 multiply, so the arithmetic runs in int64 and
    is masked to 32 bits after every step (the low 32 bits of a product
    survive int64 wraparound)."""
    h = (index + seed) & _MASK32
    h = (h * 0x9E3779B1) & _MASK32
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & _MASK32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & _MASK32
    return h ^ (h >> 16)


def hash_keep(n: int, seed: int, rate: float, device=None) -> torch.Tensor:
    """Keep mask of ``n`` flat elements: ``_hash_keep`` of the JAX package."""
    return hash_bits(n, seed, device) >= keep_threshold(rate)


def shard_index(shape, origin: int = 0, row_len=None,
                device=None) -> torch.Tensor:
    """The global flat indices (int64) of a shard of ``shape`` (see the
    module's docstring)."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    last = shape[-1] if len(shape) else 1
    if row_len is not None and row_len != last:
        i = (i // last) * row_len + i % last
    return (i + origin).view(shape)


def _last_index(shape, origin: int, row_len) -> int:
    """The largest global index of a shard (``shard_index``'s last)."""
    n = math.prod(shape)
    last = shape[-1] if len(shape) else 1
    if row_len is None or row_len == last or n == 0:
        return origin + n - 1
    return origin + (n // last - 1) * row_len + last - 1


def dropout_reference(x: torch.Tensor, seed: int, rate: float,
                      origin: int = 0, row_len=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``_hash_apply``, at the shard's
    global indices."""
    if origin == 0 and row_len is None:
        keep = hash_keep(x.numel(), seed, rate, x.device).view(x.shape)
    else:
        keep = hash_bits_at(shard_index(x.shape, origin, row_len, x.device),
                            seed) >= keep_threshold(rate)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def _apply(x: torch.Tensor, seed: int, rate: float, origin: int = 0,
           row_len=None) -> torch.Tensor:
    """One dropout pass on x's device: plain on the CPU, kernel on CUDA."""
    if _last_index(x.shape, origin, row_len) >= 2 ** 32:
        raise ValueError("dropout: a global index of 2^32 or more (the "
                         "hash takes a 32-bit flat index)")
    if x.device.type == "cpu":
        return dropout_reference(x, seed, rate, origin, row_len)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dropout kernel: f32 or bf16 only, got {x.dtype}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()                   # the kernel reads 16 bytes a thread
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype))
    last = x.shape[-1] if x.dim() else 1
    err = _build.load().hash_dropout(
        x.data_ptr(), y.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
        seed, keep_threshold(rate), scale, origin & _MASK32, last,
        last if row_len is None else row_len,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "hash_dropout")
    dropout.launches += 1
    return y


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed: int, rate: float, origin: int, row_len):
        ctx.args = (seed, rate, origin, row_len)
        return _apply(x, seed, rate, origin, row_len)

    @staticmethod
    def backward(ctx, g):
        # same (seed, index) → the same keep mask, regenerated
        return _apply(g, *ctx.args), None, None, None, None


def dropout(x: torch.Tensor, rate: float, seed: int, origin: int = 0,
            row_len=None) -> torch.Tensor:
    """``fast_dropout`` with a seed drawn by the caller: identity for
    ``rate <= 0``, zeros for ``rate >= 1``, else the hash dropout, with the
    mask of the global indices ``origin`` / ``row_len`` give a shard."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:   # as nn.Dropout: drop everything, no 1/(1-rate) inf
        return torch.zeros_like(x)
    return _HashDropout.apply(x, int(seed), float(rate), int(origin),
                              None if row_len is None else int(row_len))


# Plain count of kernel launches (forward and backward passes alike): a run
# reads it to show it went through the kernel. Only a launch adds to it.
dropout.launches = 0
