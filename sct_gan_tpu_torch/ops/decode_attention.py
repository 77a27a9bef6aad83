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

f32 caches (the TASC decoder's, as in the JAX package, and f32 generation
of ``compute_dtype="float32"``) run their own kernel,
``csrc/decode_attention_f32.cu``: split-K over bulk-copied tiles, the
splits of a (b, h) combined in one cluster of up to 16 blocks
(``decode_splits_f32``). Its route is its own (``decode_route_f32``): any
head dim that is a multiple of 4 runs in place (its rows are whole 16-byte
units), up to ``F32_WIDE_CHUNK`` on an instance of the kernel and above on
its column-chunk route (``decode_chunks_f32``), any other head dim on a
copy padded to the next multiple of 4. No head dim raises, as in the JAX
kernel. The query is read as it is, bf16 or f32, and the output comes back
in the query's dtype, as the JAX kernel's does.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from . import _build
from .attention import mha_reference
from .flash_attention import (_mask_arg, _strides, head_strides,
                              pad_head_dim)

# head dims with a kernel instance; the plain version takes any
DECODE_HEAD_DIMS = (64, 96, 128, 192)
# the column chunk of the wide-head route, which takes any head dim over
# 192 (a multiple of 8) in as many chunks as hold it
WIDE_CHUNK = 128
UNIT = 8            # bf16 elements of the kernel's 16-byte copies
TILE_KEYS = 64      # keys a tile of the kernel
MAX_SPLITS = 8      # blocks a (b, h): one portable thread block cluster
CARD_SMS = 132      # streaming multiprocessors of an H100 SXM
# the f32-cache kernel: f32 elements of its 16-byte rows, the column chunk
# of its column-chunk route (the largest head dim its instances take), the
# blocks a (b, h, chunk) (one non-portable cluster) and the warps of a
# block, each of which takes its own keys of every tile
F32_UNIT = 4
F32_WIDE_CHUNK = 1024
MAX_SPLITS_F32 = 16
F32_WARPS = 8


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


def split_ranges(s: int, splits: int,
                 tile: int = TILE_KEYS) -> List[Tuple[int, int]]:
    """The key range [begin, end) of each split, as the kernels cut them:
    split r takes the tiles [r T / splits, (r + 1) T / splits) of the T
    ``tile``-key tiles (64 keys in the bf16 kernel)."""
    tiles = -(-s // tile)
    return [(r * tiles // splits * tile,
             min(s, (r + 1) * tiles // splits * tile))
            for r in range(splits)]


def decode_route_f32(d: int) -> int:
    """The head dim the f32-cache kernel computes at for head dim ``d``:
    ``d`` itself when its f32 rows are whole 16-byte units (a multiple of
    4; 16, 48, 80, 132, 192, 384, 516, 768, 1028 in place), else the next
    multiple of 4, which the wrapper hands the kernel as a zero-padded copy
    (30 -> 32)."""
    return -(-d // F32_UNIT) * F32_UNIT


def decode_chunks_f32(d: int) -> int:
    """Column chunks of the f32-cache kernel at head dim ``d``: 1 up to
    ``F32_WIDE_CHUNK`` (an instance holds the whole row), above as many
    ``F32_WIDE_CHUNK``-column chunks of o as hold it (the column-chunk
    route: one cluster of splits a chunk, each reading the whole K row)."""
    return max(1, -(-d // F32_WIDE_CHUNK))


def decode_tile_keys_f32(d: int) -> int:
    """Keys a tile of the f32-cache kernel at head dim ``d``: 64 up to 128,
    32 up to 192, 16 up to 512, 8 above (one key a warp), so that a ring
    stage of K and V rows stays at most 64 KB, and at most 48 KB (two
    blocks an SM) from 132 to 384 and from 516 to 768; the column-chunk
    route past 1024 keeps the 8-key tiles' splits and keys a warp."""
    return 64 if d <= 128 else 32 if d <= 192 else 16 if d <= 512 else 8


def decode_splits_f32(b: int, h: int, s: int, d: int) -> int:
    """Blocks that share the keys of one (b, h) in the f32-cache kernel (of
    one (b, h, chunk) past ``F32_WIDE_CHUNK``: the caller passes B times
    ``decode_chunks_f32(d)`` as ``b``): a
    power of two, at most the tiles of S (``decode_tile_keys_f32``: no
    split is empty) and at most what keeps B * H * splits within two
    blocks an SM of the card (1 from B * H = 133 up); at most 8 (a
    portable cluster) unless 8 would leave a split more than 4 tiles, then
    at most ``MAX_SPLITS_F32``. On the card at B = 2 and 1024 keys, 8 was
    the best count at head dims 64 to 192 (16 cost 28-40% more), 16 at 256
    and 384 (8 cost 41-44% more: a warp walks its split's tiles one after
    another), and cluster sizes that are not a power of two (5, 6, 11)
    cost up to 76% more (PERF.md §6)."""
    tiles = -(-s // decode_tile_keys_f32(d))
    cap = MAX_SPLITS_F32 if tiles > 4 * MAX_SPLITS else MAX_SPLITS
    most = max(1, min(cap, tiles, 2 * CARD_SMS // (b * h)))
    return 1 << (most.bit_length() - 1)


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               mask: Optional[torch.Tensor] = None, *,
                               sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same arguments, same result, in
    q's dtype (f32 caches with a bf16 query give bf16, as the JAX kernel)."""
    return mha_reference(q, k, v, key_padding_mask=mask,
                         sm_scale=sm_scale).to(q.dtype)



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


def decode_attention_f32_split_reference(q: torch.Tensor, k: torch.Tensor,
                                         v: torch.Tensor,
                                         mask: Optional[torch.Tensor] = None,
                                         *, sm_scale: float,
                                         splits: int) -> torch.Tensor:
    """The f32-cache kernel's arithmetic in plain PyTorch, f32: a test
    oracle, which the main path never calls. Split r takes its tiles
    (``split_ranges`` of ``decode_tile_keys_f32(d)``-key tiles); in every
    tile, warp w of ``F32_WARPS`` takes keys [w G, (w + 1) G) (G = tile /
    warps) and keeps its own online softmax (m, l, o; base-2 exponents,
    q pre-scaled by scale * log2 e); the warps' (m, l, o) are combined in
    warp order, then the splits' in split order. Same arguments and
    result as ``decode_attention_reference``."""
    b, h, _, d = q.shape
    s = k.shape[2]
    tile = decode_tile_keys_f32(d)
    w, g = F32_WARPS, tile // F32_WARPS
    qf = q.float() * (sm_scale * math.log2(math.e))
    live = (torch.ones(b, s, dtype=torch.bool, device=q.device)
            if mask is None else mask.bool())
    pad = -(-s // tile) * tile - s            # keys past S: never attended
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    live = torch.nn.functional.pad(live, (0, pad))

    def combine(m, l, o, dim):
        """(m, l, o) combined over ``dim`` in index order."""
        m_max = m.amax(dim, keepdim=True)
        f = torch.where(torch.isinf(m), 0.0,
                        torch.exp2(m - torch.where(torch.isinf(m_max), 0.0,
                                                   m_max)))
        l_all, o_all = 0.0, 0.0
        for i in range(m.shape[dim]):
            fi = f.select(dim, i)
            l_all = l_all + l.select(dim, i) * fi
            o_all = o_all + o.select(dim, i) * fi
        return m_max.squeeze(dim), l_all, o_all

    ms, ls, os_ = [], [], []
    for lo, hi in split_ranges(s, splits, tile):
        m = torch.full((b, h, w, 1), -math.inf, device=q.device)
        l = torch.zeros(b, h, w, 1, device=q.device)
        o = torch.zeros(b, h, w, d, device=q.device)
        for t0 in range(lo, hi, tile):
            kt = kf[:, :, t0:t0 + tile].reshape(b, h, w, g, d)
            vt = vf[:, :, t0:t0 + tile].reshape(b, h, w, g, d)
            on = live[:, None, t0:t0 + tile].reshape(b, 1, w, g)
            sc = (kt @ qf.reshape(b, h, 1, d, 1)).squeeze(-1)   # (b,h,w,g)
            sc = sc.masked_fill(~on, -math.inf)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            # -inf only while a warp has seen no attended key: a = p = 0
            base = torch.where(torch.isinf(m_new), 0.0, m_new)
            a, p = torch.exp2(m - base), torch.exp2(sc - base)
            l = l * a + p.sum(-1, keepdim=True)
            o = o * a + (p.unsqueeze(-2) @ vt).squeeze(-2)
            m = m_new
        m, l, o = combine(m, l, o, 2)                 # the warps
        ms.append(m)
        ls.append(l)
        os_.append(o)
    _, l_all, o_all = combine(torch.stack(ms), torch.stack(ls),
                              torch.stack(os_), 0)    # the splits
    out = torch.where(l_all > 0, o_all / torch.where(l_all > 0, l_all, 1.0),
                      0.0)
    return out.reshape(b, h, 1, d).to(q.dtype)


def decode_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  f32: bool = False):
    """Check the shapes and layouts the kernel takes and return the (sb,
    sh, ss) strides of q, k and v: one query, any S >= 1, a head dim the
    kernel takes as it is (``decode_runs_on_kernel``: a multiple of 8; with
    ``f32``, the f32-cache kernel's, ``decode_route_f32``: a multiple of 4;
    any other head dim has rows that are not whole 16-byte units, and the
    wrapper hands the kernel a padded copy); k and v rows on
    16-byte lines (the kernels' 16-byte and bulk copies), q on 4-byte
    lines. It reads only shapes, strides and base addresses, so it holds
    for a tensor on any device."""
    b, h, sq, d = q.shape
    s = k.shape[2]
    if sq != 1 or k.shape != (b, h, s, d) or v.shape != (b, h, s, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    unit = F32_UNIT if f32 else UNIT
    in_place = d % unit == 0 if f32 else decode_runs_on_kernel(d)
    if not in_place or s < 1:
        raise ValueError(f"head dim {d} / keys {s} not supported (head dims "
                         f"that are multiples of {unit}, at least one key)")
    return (head_strides(q, "q", 4), head_strides(k, "k", 16),
            head_strides(v, "v", 16))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, *,
                     sm_scale: float) -> torch.Tensor:
    """Attention of one query per (b, h) against S keys.

    q: (B, H, 1, dh); k, v: (B, H, S, dh), any (b, h, s) strides with rows
    on 16-byte lines; mask: (B, S) bool, True = attend, or None for all S
    keys visible. Returns (B, H, 1, dh) in q's dtype. A fully-masked row
    gives zeros. On CUDA, bf16 q, k and v (``decode_route``): a dh up to
    192 runs on the smallest kernel instance that holds it, a dh over 192
    on the wide-head route (one block per 128 columns of the output); a
    multiple of 8 in place, any other dh on a copy padded to its route's
    head dim. f32 k and v with a bf16 or f32 q run the f32-cache kernel
    (``decode_route_f32``: any multiple of 4 in place, on an instance up to
    1024 and on the column-chunk route above); any other mix raises.
    """
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, mask, sm_scale=sm_scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if k.dtype == v.dtype == torch.float32 and q.dtype in (torch.bfloat16,
                                                           torch.float32):
        return _decode_f32(q, k, v, mask, sm_scale)
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise ValueError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: "
                         f"the kernels take bf16 q, k, v, or f32 k and v "
                         f"with a bf16 or f32 q")
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


def _decode_f32(q, k, v, mask, sm_scale: float,
                splits: Optional[int] = None) -> torch.Tensor:
    """``decode_attention`` over f32 caches: the f32 kernel, one launch,
    the query read as it is (bf16 or f32) and the output in its dtype.
    ``splits`` overrides ``decode_splits_f32`` (a timing tool's choice);
    past ``F32_WIDE_CHUNK`` the split rule counts each column chunk's
    clusters as the bf16 wide-head route does."""
    d = q.shape[-1]
    dk = decode_route_f32(d)
    if dk != d:     # a padded copy: zero columns add nothing
        out = _decode_f32(*(pad_head_dim(t, dk) for t in (q, k, v)), mask,
                          sm_scale, splits)
        return out[..., :d]
    qs, ks, vs = decode_layout(q, k, v, f32=True)
    b, h, _, _ = q.shape
    s = k.shape[2]
    out = torch.empty(b, h, 1, d, dtype=q.dtype, device=q.device)
    os_ = _strides(out, "out", 4)
    mptr, msb, _keep = _mask_arg(mask, b, s, q.device)
    err = _build.load().decode_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mptr, out.data_ptr(),
        b, h, s, d, *qs, *ks, *vs, *os_, msb,
        splits or decode_splits_f32(b * decode_chunks_f32(d), h, s, d),
        ctypes.c_float(sm_scale),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention_f32")
    decode_attention.f32_launches += 1
    return out


# Plain counts of kernel launches: a run reads them to show it went through
# the kernels. Only a successful launch adds to them. ``launches`` counts
# the bf16 kernel, ``f32_launches`` the f32-cache one.
decode_attention.launches = 0
decode_attention.f32_launches = 0
