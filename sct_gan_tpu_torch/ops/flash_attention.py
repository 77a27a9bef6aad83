"""Flash attention: the hand-written CUDA kernels and their plain version.

Counterpart of ``sct_gan_tpu/ops/flash_attention.py``. On a CUDA tensor,
``flash_attention`` is an autograd function:

  * forward: ``csrc/flash_attention_fwd.cu`` (the TPU ``_fa_fwd_kernel``),
    with the optional attention-weight dropout and the f32 per-row LSE;
  * backward: ``csrc/flash_attention_bwd.cu``, a dKV kernel and a dQ kernel
    (the TPU ``_fa_bwd_fused_kernel`` at nk == 1 and the ``_fa_dkv_kernel``
    / ``_fa_dq_kernel`` pair at nk > 1). ``D = rowsum(dO ∘ O)`` is computed
    here in f32, as the JAX package computes it in XLA outside its kernels.

The dropout mask is the JAX package's hash stream over the flat
(B, H, Sq, Sk) index (``ops/dropout.py``), the mask ``mha_reference``
draws, so the kernels and the plain version agree entry for entry.

On a CPU tensor it runs the plain version, ``flash_attention_reference``,
whose gradient is plain autograd through ``mha_reference``. The kernels'
headers say what bounds them on an H100 and what their design does about it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import attention_lse, mha_reference
from .dropout import keep_threshold

KERNEL_HEAD_DIM = 96   # the model's d / H; the plain version takes any


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              key_padding_mask: Optional[torch.Tensor] = None,
                              causal: bool = False,
                              sm_scale: Optional[float] = None,
                              dropout_rate: float = 0.0, seed: int = 0,
                              return_lse: bool = False):
    """Plain PyTorch version of the kernels: same arguments, same result;
    its gradient is autograd through ``mha_reference``."""
    out = mha_reference(q, k, v, key_padding_mask=key_padding_mask,
                        causal=causal, sm_scale=sm_scale,
                        dropout_rate=dropout_rate, seed=seed)
    if return_lse:
        return out, attention_lse(q, k, key_padding_mask=key_padding_mask,
                                  causal=causal, sm_scale=sm_scale)
    return out


def _strides(t: torch.Tensor, name: str, align: int):
    """(sb, sh, ss) element strides of a (B, H, S, D) bf16 CUDA tensor whose
    last dim is contiguous and whose rows start on ``align``-byte lines."""
    if t.device.type != "cuda" or t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: expected a bf16 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"{name}: expected (B, H, S, D) with a contiguous "
                         f"last dim, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")
    el = align // 2
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
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:3])):
        return t
    return t.contiguous()


def _dropout_args(rate: float, seed: int):
    if rate <= 0.0:
        return 0, 0, 0, ctypes.c_float(1.0)
    return 1, seed, keep_threshold(rate), ctypes.c_float(1.0 / (1.0 - rate))


def _check_shapes(q, k, v):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernels are built for "
                         f"{KERNEL_HEAD_DIM}")
    if b * h * sq * sk >= 2 ** 32:
        raise ValueError("B*H*Sq*Sk must stay below 2^32 (dropout index)")
    return b, h, sq, sk, d


def _forward(q, k, v, mask, causal, scale, rate, seed, need_lse):
    """Launch the forward kernel; (out, lse or None)."""
    b, h, sq, sk, d = _check_shapes(q, k, v)
    qs, ks, vs = (_strides(q, "q", 16), _strides(k, "k", 16),
                  _strides(v, "v", 16))
    out = _heads_like(q, sq)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if need_lse else None)
    mptr, msb, _keep = _mask_arg(mask, b, sk, q.device)
    err = _build.load().flash_attention_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mptr, out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, sq, sk, d, *qs, *ks,
        *vs, *_strides(out, "out", 4), msb, int(causal), ctypes.c_float(scale),
        *_dropout_args(rate, seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd_bf16")
    flash_attention.launches += 1
    return out, lse


def flash_attention_backward(q, k, v, out, lse, dout, mask, causal, scale,
                             rate, seed):
    """Launch the backward kernel pair; (dq, dk, dv) in q's dtype, laid out
    like the forward's output. dout is read through its strides when it can
    be, else copied contiguous."""
    b, h, sq, sk, d = _check_shapes(q, k, v)
    dout = _kernel_operand(dout.to(q.dtype))
    # D = rowsum(dO ∘ O) in f32, from the bf16 dO and O (flash_attention.py:
    # 470-475 of the JAX package)
    dvec = (dout.float() * out.float()).sum(-1).contiguous()
    dq, dk, dv = _heads_like(q, sq), _heads_like(k, sk), _heads_like(v, sk)
    mptr, msb, _keep = _mask_arg(mask, b, sk, q.device)
    strides = [_strides(t, n, 16) for t, n in ((q, "q"), (k, "k"), (v, "v"),
                                               (dout, "dout"))]
    strides += [_strides(t, n, 4) for t, n in ((dq, "dq"), (dk, "dk"),
                                               (dv, "dv"))]
    err = _build.load().flash_attention_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), mptr,
        lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, sq, sk, d, *(x for s in strides for x in s),
        msb, int(causal), ctypes.c_float(scale), *_dropout_args(rate, seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd_bf16")
    flash_attention_backward.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale, rate, seed):
        out, lse = _forward(q, k, v, mask, causal, scale, rate, seed, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask, ctx.args = mask, (causal, scale, rate, seed)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                              ctx.mask, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    key_padding_mask: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0, seed: int = 0,
                    return_lse: bool = False):
    """dropout(softmax(Q Kᵀ·scale + mask [+ causal])) V over split heads.

    q: (B, H, Sq, dh); k, v: (B, H, Sk, dh); key_padding_mask: (B, Sk) bool,
    True = attend. Any (b, h, s) strides are taken as they are.
    ``dropout_rate`` > 0 drops attention weights with the hash keep mask of
    ``seed``. Returns (B, H, Sq, dh) in q's dtype (on CUDA laid out as
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
            return_lse=return_lse)
    scale = (1.0 / q.shape[-1] ** 0.5) if sm_scale is None else float(sm_scale)
    rate = float(dropout_rate) if dropout_rate > 0.0 else 0.0
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, key_padding_mask, causal,
                                         scale, rate, int(seed))
    else:
        out, lse = _forward(q, k, v, key_padding_mask, causal, scale, rate,
                            int(seed), return_lse)
    return (out, lse) if return_lse else out


# Plain counts of kernel launches: a run reads them to show it went through
# the kernels. Only a successful launch adds to them; the backward counts
# one launch of its kernel pair.
flash_attention.launches = 0
flash_attention_backward.launches = 0
