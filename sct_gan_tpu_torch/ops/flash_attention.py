"""Flash attention: the hand-written CUDA kernels and their plain version.

Counterpart of ``sct_gan_tpu/ops/flash_attention.py``. On a CUDA tensor,
``flash_attention`` is an autograd function:

  * forward: ``csrc/flash_attention_fwd.cu`` (the TPU ``_fa_fwd_kernel``),
    with the optional attention-weight dropout and the f32 per-row LSE,
    one launch a call. Every instance walks only the key tiles that hold
    an attended key (and, under ``causal``, that its query rows see); at
    head dims 64, 96 and 128 it is ``flash_fwd_hopper_kernel``: a producer
    warpgroup that loads by TMA and gives its registers to two consumer
    warpgroups (``setmaxnreg``), each of which runs one tile's softmax
    while its previous tile's P V and the other warpgroup's products are
    on the tensor cores;
  * backward: ``csrc/flash_attention_bwd.cu``, a dKV kernel and a dQ kernel
    (the TPU ``_fa_bwd_fused_kernel`` at nk == 1 and the ``_fa_dkv_kernel``
    / ``_fa_dq_kernel`` pair at nk > 1; at head dims 64, 96 and 128 the
    templates of ``csrc/flash_bwd_hopper.cuh``), both reading q, k, v and dO
    by TMA through the caller's strides and skipping key blocks and tiles
    with no attended key. A first kernel computes ``D = rowsum(dO ∘ O)``
    in f32, which the JAX package computes in XLA outside its kernels.

The dropout mask is the JAX package's hash stream over the flat
(B, H, Sq, Sk) index (``ops/dropout.py``), the mask ``mha_reference``
draws, so the kernels and the plain version agree entry for entry. Under a
mesh, ``drop_shard`` = (b0, h0, hg) keys a shard's mask at its place in the
global (B, hg, Sq, Sk) grid, where the single-card call would draw it.

The kernels have one instance each for head dims 64, 96, 128, 192 and 256
(``KERNEL_HEAD_DIMS``). Any other head dim up to 256 takes the next larger
instance through a zero-padded copy of q, k and v made here (a slow route:
one copy of each per call); the scale stays that of the true head dim and
the output is sliced back, so the result is the same. A head dim over 256
is padded so to the smallest multiple of 256 or of 192 that holds it (256
where both do: ``CHUNK_WIDTHS``) and runs in chunks of that instance: one
block per column chunk of the output, the scores recomputed over the full
head dim in every chunk's block (``kernel_route``).

f32 operands (CodeBERT, ``compute_dtype="float32"``) run their own
kernels, ``csrc/flash_attention_fwd_f32.cu`` and
``csrc/flash_attention_bwd_f32.cu`` (the D vector, dKV and dQ), with the
same arguments, dropout bits and masked-tile skips, every product at f32
accuracy (3xTF32 on the tensor cores). They have instances for head dims
64, 96 and 128 (``F32_HEAD_DIMS``); a smaller head dim takes the next
instance through a zero-padded copy (``kernel_route_f32``), and an f32 head
dim over 128 raises. q, k and v share one dtype, bf16 or f32; there is no
cast between them.

On a CPU tensor it runs the plain version, ``flash_attention_reference``,
whose gradient is plain autograd through ``mha_reference``. The kernels'
headers say what bounds them on an H100 and what their design does about it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .attention import attention_lse, mha_reference
from .dropout import keep_threshold

# head dims with a kernel instance; the plain version takes any
KERNEL_HEAD_DIMS = (64, 96, 128, 192, 256)
# head dims with an f32 kernel instance
F32_HEAD_DIMS = (64, 96, 128)
# the chunk widths of the route over 256, the preferred first
CHUNK_WIDTHS = (256, 192)


def kernel_route(d: int):
    """(instance, chunks) that head dim ``d`` runs as on the card: the
    smallest of ``KERNEL_HEAD_DIMS`` that holds it, in one chunk; over 256
    the smallest multiple of 256 or of 192 that holds it, 256 where both
    do, in chunks of that instance. 160 -> (192, 1), 320 and 384 -> (192,
    2), 512 -> (256, 2), 768 -> (256, 3)."""
    for dk in KERNEL_HEAD_DIMS:
        if d <= dk:
            return dk, 1
    padded, width = min((-(-d // w) * w, -w) for w in CHUNK_WIDTHS)
    return -width, padded // -width


def kernel_route_f32(d: int) -> int:
    """The f32 instance that head dim ``d`` runs on, in the f32 flash
    kernels and the f32-cache decode kernel alike: the smallest of
    ``F32_HEAD_DIMS`` that holds it (16 -> 64, 80 -> 96). An f32 head dim
    over 128 has no route and raises."""
    for dk in F32_HEAD_DIMS:
        if d <= dk:
            return dk
    raise ValueError(f"head dim {d} in float32: the f32 kernels have "
                     f"instances for head dims up to {F32_HEAD_DIMS[-1]} "
                     f"({F32_HEAD_DIMS})")


def kernel_head_dim(d: int, dtype=torch.bfloat16) -> int:
    """The head dim a head dim ``d`` of ``dtype`` runs at on the card: ``d``
    padded to its ``kernel_route`` (f32: ``kernel_route_f32``)."""
    if dtype == torch.float32:
        return kernel_route_f32(d)
    width, chunks = kernel_route(d)
    return width * chunks


def runs_on_kernel(d: int, dtype=torch.bfloat16) -> bool:
    """Whether the kernels take head dim ``d`` as it is, with no padded
    copy: an instance, or (bf16) over 256 a multiple of 256 or of 192."""
    if dtype == torch.float32:
        return d in F32_HEAD_DIMS
    return kernel_head_dim(d) == d


def pad_head_dim(t: torch.Tensor, dk: int) -> torch.Tensor:
    """A copy of ``t`` zero-padded on its last dim to ``dk``: zero columns
    of q and k add nothing to a score, and zero columns of v give output
    columns that are sliced away."""
    return F.pad(t, (0, dk - t.shape[-1]))


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              key_padding_mask: Optional[torch.Tensor] = None,
                              causal: bool = False,
                              sm_scale: Optional[float] = None,
                              dropout_rate: float = 0.0, seed: int = 0,
                              return_lse: bool = False, drop_shard=None):
    """Plain PyTorch version of the kernels: same arguments, same result;
    its gradient is autograd through ``mha_reference``."""
    out = mha_reference(q, k, v, key_padding_mask=key_padding_mask,
                        causal=causal, sm_scale=sm_scale,
                        dropout_rate=dropout_rate, seed=seed,
                        drop_shard=drop_shard)
    if return_lse:
        return out, attention_lse(q, k, key_padding_mask=key_padding_mask,
                                  causal=causal, sm_scale=sm_scale)
    return out


KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _strides(t: torch.Tensor, name: str, align: int):
    """(sb, sh, ss) element strides of a (B, H, S, D) bf16 or f32 CUDA
    tensor laid out as ``head_strides`` requires."""
    if t.device.type != "cuda" or t.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: expected a bf16 or f32 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    return head_strides(t, name, align)


def head_strides(t: torch.Tensor, name: str, align: int):
    """(sb, sh, ss) element strides of a (B, H, S, D) tensor whose last dim
    is contiguous and whose base and rows start on ``align``-byte lines
    (strides in whole ``align``-byte units of its element size). The
    kernels read q, k, v and dO at ``align`` = 16: the bf16 forward through
    rank-4 (D, S, H, B) TMA maps built from these strides (a map takes only
    byte strides of whole 16-byte units), the bf16 backward pair through the
    same maps, the f32 kernels by 16-byte cp.async copies. The model's head
    views of (B, S, H*96) pass as they are. It reads only the shape, the
    strides and the base address, so it holds for a tensor on any device."""
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"{name}: expected (B, H, S, D) with a contiguous "
                         f"last dim, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")
    el = max(1, align // t.element_size())
    sb, sh, ss = t.stride(0), t.stride(1), t.stride(2)
    if t.data_ptr() % align or any(s % el for s in (sb, sh, ss)):
        raise ValueError(f"{name}: rows must start on {align}-byte lines "
                         f"(strides {t.stride()})")
    if max(sb, sh, ss) >= 2 ** 31:     # offsets are 64-bit in the kernels
        raise ValueError(f"{name}: a stride does not fit 32 bits")
    return sb, sh, ss


def _mask_arg(mask: Optional[torch.Tensor], b: int, sk: int, device):
    """(pointer, row stride, tensor kept alive) for a (B, Sk) key mask."""
    if mask is None:
        return None, 0, None
    if mask.shape != (b, sk) or mask.device != device:
        raise ValueError(f"key mask: expected ({b}, {sk}) on {device}, got "
                         f"{tuple(mask.shape)} on {mask.device}")
    # a bool tensor is read as its bytes in place: no copy per call
    m = (mask if mask.dtype == torch.bool else mask != 0).view(torch.uint8)
    if m.stride(1) != 1:
        m = m.contiguous()
    return m.data_ptr(), m.stride(0), m


def _heads_like(ref: torch.Tensor, s: int) -> torch.Tensor:
    """An empty (B, H, s, dh) tensor laid out in memory as (B, s, H, dh), so
    that merging the heads afterwards is a free view."""
    b, h, _, d = ref.shape
    return torch.empty(b, s, h, d, dtype=ref.dtype,
                       device=ref.device).transpose(1, 2)


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernels can read it through its strides (last dim
    contiguous, rows on 16-byte lines), else a contiguous copy: autograd may
    hand the backward a gradient in any layout."""
    el = 16 // t.element_size()
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % el == 0 for s in t.stride()[:3])):
        return t
    return t.contiguous()


def _dropout_args(rate: float, seed: int, shard):
    """The kernels' dropout arguments: on, seed, threshold, 1/(1-rate) and
    the shard's (b0, h0, hg)."""
    if rate <= 0.0:
        return 0, 0, 0, ctypes.c_float(1.0), 0, 0, 0
    return (1, seed, keep_threshold(rate), ctypes.c_float(1.0 / (1.0 - rate)),
            *shard)


def _check_dtypes(q, k, v) -> None:
    """q, k and v share one dtype the kernels take: bf16 or f32."""
    if not q.dtype == k.dtype == v.dtype or q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: "
                         f"the kernels take one of bf16 or f32 for all three")


def _check_shapes(q, k, v, rate: float, shard=None):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    _check_dtypes(q, k, v)
    if q.dtype == torch.float32:
        if not runs_on_kernel(d, q.dtype):
            raise ValueError(f"head dim {d} in float32: the f32 kernels "
                             f"have instances for {F32_HEAD_DIMS} "
                             f"(flash_attention pads smaller head dims)")
    elif not runs_on_kernel(d):
        raise ValueError(f"head dim {d}: the kernels have instances for "
                         f"{KERNEL_HEAD_DIMS} and, over 256, multiples of "
                         f"{' or '.join(map(str, CHUNK_WIDTHS))} "
                         f"(flash_attention pads other head dims)")
    # only the dropout hash takes the 32-bit flat (b, h, i, j) index, of the
    # global grid the shard sits in
    b0, h0, hg = shard or (0, 0, h)
    if rate > 0.0 and ((b0 + b - 1) * hg + h0 + h) * sq * sk >= 2 ** 32:
        raise ValueError("with dropout, B*H*Sq*Sk must stay below 2^32 "
                         "(the dropout index)")
    return b, h, sq, sk, d


def _forward(q, k, v, mask, causal, scale, rate, seed, need_lse, shard):
    """Launch the forward kernel; (out, lse or None)."""
    b, h, sq, sk, d = _check_shapes(q, k, v, rate, shard)
    qs, ks, vs = (_strides(q, "q", 16), _strides(k, "k", 16),
                  _strides(v, "v", 16))
    out = _heads_like(q, sq)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if need_lse else None)
    mptr, msb, _keep = _mask_arg(mask, b, sk, q.device)
    f32 = q.dtype == torch.float32
    name = "flash_attention_fwd_f32" if f32 else "flash_attention_fwd_bf16"
    err = getattr(_build.load(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mptr, out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, sq, sk, d, *qs, *ks,
        *vs, *_strides(out, "out", 4), msb, int(causal), ctypes.c_float(scale),
        *_dropout_args(rate, seed, shard),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)
    if f32:
        flash_attention.f32_launches += 1
    else:
        flash_attention.launches += 1
    return out, lse


def backward_call(q, k, v, out, lse, dout, mask, causal, scale, rate, seed,
                  shard=None, dvec=None):
    """The arguments of the backward's C entry point
    (``flash_attention_bwd_bf16``, or ``_f32`` for f32 operands: the same
    arguments) for the forward's ``out`` and dO =
    ``dout``, both laid out as the kernels read them, with (dq, dk, dv)
    allocated laid out like the forward's output and D = rowsum(dO ∘ O) the
    entry point fills (or ``dvec``, D already computed, for an entry that
    reads it): (arguments, (dq, dk, dv), tensors the call must keep
    alive)."""
    shard = shard or (0, 0, q.shape[1])
    b, h, sq, sk, d = _check_shapes(q, k, v, rate, shard)
    dq, dk, dv = _heads_like(q, sq), _heads_like(k, sk), _heads_like(v, sk)
    if dvec is None:
        dvec = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    mptr, msb, keep = _mask_arg(mask, b, sk, q.device)
    strides = [_strides(t, n, 16) for t, n in ((q, "q"), (k, "k"), (v, "v"),
                                               (dout, "dout"), (out, "out"))]
    strides += [_strides(t, n, 4) for t, n in ((dq, "dq"), (dk, "dk"),
                                               (dv, "dv"))]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            out.data_ptr(), mptr, lse.data_ptr(), dvec.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d,
            *(x for st in strides for x in st), msb, int(causal),
            ctypes.c_float(scale), *_dropout_args(rate, seed, shard),
            torch.cuda.current_stream(q.device).cuda_stream)
    return args, (dq, dk, dv), (keep, dvec)


def flash_attention_backward(q, k, v, out, lse, dout, mask, causal, scale,
                             rate, seed, shard=None):
    """Launch the backward kernels; (dq, dk, dv) in q's dtype, laid out like
    the forward's output. dout and out are read through their strides when
    they can be, else copied contiguous. D = rowsum(dO ∘ O), which the JAX
    package computes in XLA before its kernels, is the first of them (f32,
    from dO and O)."""
    dout = _kernel_operand(dout.to(q.dtype))
    args, grads, _keep = backward_call(q, k, v, _kernel_operand(out), lse,
                                       dout, mask, causal, scale, rate, seed,
                                       shard)
    f32 = q.dtype == torch.float32
    name = "flash_attention_bwd_f32" if f32 else "flash_attention_bwd_bf16"
    err = getattr(_build.load(), name)(*args)
    _build.check(err, name)
    if f32:
        flash_attention_backward.f32_launches += 1
    else:
        flash_attention_backward.launches += 1
    return grads


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale, rate, seed, shard):
        out, lse = _forward(q, k, v, mask, causal, scale, rate, seed, True,
                            shard)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask, ctx.args = mask, (causal, scale, rate, seed, shard)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                              ctx.mask, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    key_padding_mask: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0, seed: int = 0,
                    return_lse: bool = False, drop_shard=None):
    """dropout(softmax(Q Kᵀ·scale + mask [+ causal])) V over split heads.

    q: (B, H, Sq, dh); k, v: (B, H, Sk, dh); key_padding_mask: (B, Sk) bool,
    True = attend. Any (b, h, s) strides are taken as they are. On CUDA, q,
    k and v are all bf16 or all f32 (else it raises). bf16: dh 64, 96, 128,
    192 or 256 runs its kernel instance directly, any other dh <= 256
    through a zero-padded copy, and dh > 256 in chunks of the 256 or 192
    instance (through a zero-padded copy unless dh is a multiple of one:
    ``kernel_route``). f32: dh 64, 96 or 128 runs its f32 instance, a
    smaller dh through a zero-padded copy (``kernel_route_f32``), and a dh
    over 128 raises.
    ``dropout_rate`` > 0 drops attention weights with the hash keep mask of
    ``seed``, at ``drop_shard`` = (b0, h0, hg) in the global grid (None: the
    call is the whole grid). Returns (B, H, Sq, dh) in q's dtype (on CUDA laid out as
    (B, Sq, H, dh), so merging the heads afterwards is a free view), and
    with ``return_lse`` also the f32 (B, H, Sq) row log-sum-exp.
    Differentiable in q, k and v on both devices.
    """
    if dropout_rate >= 1.0:
        raise ValueError(f"attention dropout rate {dropout_rate} >= 1")
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, key_padding_mask=key_padding_mask, causal=causal,
            sm_scale=sm_scale, dropout_rate=dropout_rate, seed=seed,
            return_lse=return_lse, drop_shard=drop_shard)
    d = q.shape[-1]
    scale = (1.0 / d ** 0.5) if sm_scale is None else float(sm_scale)
    rate = float(dropout_rate) if dropout_rate > 0.0 else 0.0
    shard = tuple(int(x) for x in (drop_shard or (0, 0, q.shape[1])))
    dk = kernel_head_dim(d, q.dtype)
    if dk != d:   # padded: autograd slices the gradients back
        q, k, v = (pad_head_dim(t, dk) for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, key_padding_mask, causal,
                                         scale, rate, int(seed), shard)
    else:
        out, lse = _forward(q, k, v, key_padding_mask, causal, scale, rate,
                            int(seed), return_lse, shard)
    if dk != d:
        out = out[..., :d]
    return (out, lse) if return_lse else out


# Plain counts of kernel launches: a run reads them to show it went through
# the kernels. Only a successful launch adds to them; the backward counts
# one launch of its kernel pair. ``launches`` counts the bf16 kernels,
# ``f32_launches`` the f32 ones.
flash_attention.launches = 0
flash_attention.f32_launches = 0
flash_attention_backward.launches = 0
flash_attention_backward.f32_launches = 0
