"""Single-query (decode-step) attention: the CUDA kernel and its plain version.

Counterpart of ``sct_gan_tpu/ops/decode_attention.py`` (the TPU kernel
``_kernel``). The kernel lives in ``csrc/decode_attention.cu``; its header
says what bounds it on an H100 and what its design does about that: split-K
over the keys, the splits of a (b, h) combined inside the same launch.

K and V are taken through their strides. The KV-cached decode loop passes
the cache cut to the live length (``k_cache[:, :, :pos + 1]``, a view), so
the kernel reads no key past ``pos`` and the cache is never copied. That
replaces the JAX loop's ``cache_chunk`` re-slicing, which exists only to
bound reads under static shapes; the numbers are the same, because keys
past ``pos`` are masked there.

Head dims (``decode_route``): instances for 64, 96, 128 and 192
(``DECODE_HEAD_DIMS``); over 192 the wide-head route, in chunks of
``WIDE_CHUNK`` columns. Any head dim that is a multiple of 8 runs in place:
on the smallest instance that holds it (80 on 96, 160 on 192), or on the
wide-head route's chunks (224, 256, 320 and 384 in 2 or 3 chunks, the last
one part full). The kernel zero-fills the missing columns in shared memory
and writes only the true ones. A head dim that is not a multiple of 8 goes
through a copy zero-padded to its route's head dim, since its rows are not
whole 16-byte units. The flash kernels route head dims their own way
(``flash_attention.kernel_route``).
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from . import _build
from .attention import mha_reference
from .flash_attention import _mask_arg, _strides, head_strides, pad_head_dim

# head dims with a kernel instance; the plain version takes any
DECODE_HEAD_DIMS = (64, 96, 128, 192)
# the column chunk of the wide-head route, which takes any head dim over
# 192 (a multiple of 8) in as many chunks as hold it
WIDE_CHUNK = 128
UNIT = 8            # bf16 elements of the kernel's 16-byte copies
TILE_KEYS = 64      # keys a tile of the kernel
MAX_SPLITS = 8      # blocks a (b, h): one portable thread block cluster
CARD_SMS = 132      # streaming multiprocessors of an H100 SXM


def decode_route(d: int) -> Tuple[int, int]:
    """(instance, chunks) that head dim ``d`` runs as on the card: the
    smallest of ``DECODE_HEAD_DIMS`` that holds it, in one chunk; over 192
    the wide-head route, ``WIDE_CHUNK``-column chunks enough to hold it.
    80 -> (96, 1), 160 -> (192, 1), 224 and 256 -> (128, 2), 320 and 384
    -> (128, 3), 512 -> (128, 4)."""
    for dk in DECODE_HEAD_DIMS:
        if d <= dk:
            return dk, 1
    return WIDE_CHUNK, -(-d // WIDE_CHUNK)


def decode_head_dim(d: int) -> int:
    """The head dim the kernel computes at for head dim ``d``: its
    ``decode_route``'s instance times chunks."""
    width, chunks = decode_route(d)
    return width * chunks


def decode_runs_on_kernel(d: int) -> bool:
    """Whether the kernel takes head dim ``d`` as it is, with no padded
    copy: rows of whole 16-byte units (``d`` a multiple of 8), on an
    instance or on the wide-head route's chunks."""
    return d % UNIT == 0


def decode_splits(b: int, h: int, s: int) -> int:
    """Blocks that share the keys of one (b, h): enough that B * H * splits
    fills one wave of the card's SMs, at most ``MAX_SPLITS`` (the cluster
    that combines them) and at most the 64-key tiles of S, so that no split
    is empty. 8 at (2, 8, 1024), 1 from B * H = 132 up.

    One rule for every route. The 192 instance fits one block an SM where
    the others fit 2 to 4, so a count past one wave waits for a whole
    split; but at every shape timed on the card the most splits within one
    wave is the same count as this rule's, and forcing 2 or 3 splits at
    B = 64 was slower than 1."""
    tiles = -(-s // TILE_KEYS)
    return max(1, min(MAX_SPLITS, tiles, -(-CARD_SMS // (b * h))))


def split_ranges(s: int, splits: int) -> List[Tuple[int, int]]:
    """The key range [begin, end) of each split, as the kernel cuts them:
    split r takes the tiles [r T / splits, (r + 1) T / splits) of the T
    64-key tiles."""
    tiles = -(-s // TILE_KEYS)
    return [(r * tiles // splits * TILE_KEYS,
             min(s, (r + 1) * tiles // splits * TILE_KEYS))
            for r in range(splits)]


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               mask: Optional[torch.Tensor] = None, *,
                               sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same arguments, same result."""
    return mha_reference(q, k, v, key_padding_mask=mask, sm_scale=sm_scale)


def decode_attention_split_reference(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor,
                                     mask: Optional[torch.Tensor] = None, *,
                                     sm_scale: float,
                                     splits: int) -> torch.Tensor:
    """The kernel's split-and-combine arithmetic in plain PyTorch, f32: a
    test oracle, which the main path never calls. Each split walks its
    64-key tiles with an online softmax (running m, l and o, base-2
    exponents), then the splits' (m, l, o) are combined in split order.
    Same arguments and result as ``decode_attention_reference``."""
    b, h, _, d = q.shape
    s = k.shape[2]
    qf = q.float() * (sm_scale * math.log2(math.e))
    kf, vf = k.float(), v.float()
    live = (torch.ones(b, s, dtype=torch.bool, device=q.device)
            if mask is None else mask.bool())
    ms, ls, os_ = [], [], []
    for lo, hi in split_ranges(s, splits):
        m = torch.full((b, h, 1, 1), -math.inf, device=q.device)
        l = torch.zeros(b, h, 1, 1, device=q.device)
        o = torch.zeros(b, h, 1, d, device=q.device)
        for t0 in range(lo, hi, TILE_KEYS):
            t1 = min(t0 + TILE_KEYS, hi)
            sc = qf @ kf[:, :, t0:t1].transpose(-1, -2)         # (b, h, 1, n)
            sc = sc.masked_fill(~live[:, None, None, t0:t1], -math.inf)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            # -inf only while nothing is attended: then p = 0, a = 0
            base = torch.where(torch.isinf(m_new), 0.0, m_new)
            a, p = torch.exp2(m - base), torch.exp2(sc - base)
            l = l * a + p.sum(-1, keepdim=True)
            o = o * a + p @ vf[:, :, t0:t1]
            m = m_new
        ms.append(m)
        ls.append(l)
        os_.append(o)
    m_max = torch.stack(ms).amax(0)
    base = torch.where(torch.isinf(m_max), 0.0, m_max)
    l_all = torch.zeros_like(ls[0])
    o_all = torch.zeros_like(os_[0])
    for m, l, o in zip(ms, ls, os_):
        w = torch.exp2(m - base)
        l_all = l_all + l * w
        o_all = o_all + o * w
    out = torch.where(l_all > 0, o_all / torch.where(l_all > 0, l_all, 1.0),
                      0.0)
    return out.to(q.dtype)


def decode_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Check the shapes and layouts the kernel takes and return the (sb,
    sh, ss) strides of q, k and v: one query, any S >= 1, a head dim the
    kernel takes as it is (``decode_runs_on_kernel``: a multiple of 8; any
    other head dim has rows that are not whole 16-byte units, and the
    wrapper hands the kernel a padded copy); k and v rows on 16-byte lines (the kernel's 16-byte copies), q
    on 4-byte lines. It reads only shapes, strides and base addresses, so
    it holds for a tensor on any device."""
    b, h, sq, d = q.shape
    s = k.shape[2]
    if sq != 1 or k.shape != (b, h, s, d) or v.shape != (b, h, s, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not decode_runs_on_kernel(d) or s < 1:
        raise ValueError(f"head dim {d} / keys {s} not supported (head dims "
                         f"that are multiples of {UNIT}, at least one key)")
    return (head_strides(q, "q", 4), head_strides(k, "k", 16),
            head_strides(v, "v", 16))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, *,
                     sm_scale: float) -> torch.Tensor:
    """Attention of one query per (b, h) against S keys.

    q: (B, H, 1, dh); k, v: (B, H, S, dh), any (b, h, s) strides with rows
    on 16-byte lines; mask: (B, S) bool, True = attend, or None for all S
    keys visible. Returns (B, H, 1, dh) in q's dtype. A fully-masked row
    gives zeros. On CUDA (``decode_route``), a dh up to 192 runs on the
    smallest kernel instance that holds it, a dh over 192 on the wide-head
    route (one block per 128 columns of the output); a multiple of 8 in
    place, any other dh on a copy padded to its route's head dim.
    """
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, mask, sm_scale=sm_scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: expected a bf16 CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
    d = q.shape[-1]
    if not decode_runs_on_kernel(d):  # rows of part 16-byte units
        out = decode_attention(
            *(pad_head_dim(t, decode_head_dim(d)) for t in (q, k, v)), mask,
            sm_scale=sm_scale)
        return out[..., :d]
    qs, ks, vs = decode_layout(q, k, v)
    b, h, _, d = q.shape
    s = k.shape[2]
    out = torch.empty(b, h, 1, d, dtype=q.dtype, device=q.device)
    os_ = _strides(out, "out", 4)
    mptr, msb, _keep = _mask_arg(mask, b, s, q.device)
    # the wide-head route runs a cluster of splits per 128-column chunk
    _, chunks = decode_route(d)
    err = _build.load().decode_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mptr, out.data_ptr(),
        b, h, s, d, *qs, *ks, *vs, *os_, msb,
        decode_splits(b * chunks, h, s), ctypes.c_float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention_bf16")
    decode_attention.launches += 1
    return out


# Plain count of kernel launches: a run reads it to show it went through the
# kernel. Only a successful launch adds to it.
decode_attention.launches = 0
