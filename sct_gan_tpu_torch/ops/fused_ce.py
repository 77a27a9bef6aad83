"""Fused LM head + mean cross-entropy with a scatter-free backward.

Counterpart of ``sct_gan_tpu/ops/fused_ce.py`` (a JAX custom VJP with no
Pallas kernel; its matrix products are XLA's, here ``torch`` matmuls). The
value is the mean token CE of ``softmax(hidden @ Wᵀ + b)`` against the
targets, with the JAX op's numerics:

  * logits in the hidden's compute dtype (bf16 on the card), pad columns
    (``valid_vocab`` ≤ c < V) at -inf, logsumexp in f32;
  * backward: ``dlogits = (p − onehot)`` in the compute dtype, weighted by
    ``row_weights``, with the tiny ``g / N`` factor applied to the f32
    products rather than to dlogits;
  * nothing of size (B·S, V) is kept between forward and backward: the
    backward recomputes the logits (one matmul) and turns them into dlogits
    in place, row chunk by row chunk, so the f32 softmax is never
    materialised whole.

The bf16 matmuls on the card round their f32-accumulated products to bf16
before the ``g / N`` scale, where XLA keeps them in f32; the relative
difference is a bf16 step. On the CPU in f32 the two agree to f32 rounding.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_ROWS_PER_CHUNK = 1024   # f32 rows of a (rows, V) chunk: ~200 MB at V = 50304


def _logits(hidden, weight, bias, valid_vocab):
    dt = hidden.dtype
    logits = F.linear(hidden, weight.to(dt), bias.to(dt))
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        logits[:, valid_vocab:] = float("-inf")
    return logits


def _n_eff(targets, row_weights):
    """The count the mean divides by: a host float, or a device scalar when
    rows are weighted (no host round trip either way)."""
    if row_weights is None:
        return float(targets.numel())
    return torch.clamp_min(row_weights.float().sum() * targets.shape[1], 1.0)


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, bias, targets, row_weights, valid_vocab):
        b, s, d = hidden.shape
        h2 = hidden.reshape(b * s, d)
        t = targets.reshape(b * s).long()
        logits = _logits(h2, weight, bias, valid_vocab)
        lse = torch.cat([torch.logsumexp(c.float(), dim=-1)
                         for c in logits.split(_ROWS_PER_CHUNK)])
        picked = logits.gather(1, t[:, None])[:, 0].float()
        nll = (lse - picked).view(b, s)
        if row_weights is None:
            ce = nll.mean()
        else:
            ce = (nll * row_weights.float()[:, None]).sum() / _n_eff(
                targets, row_weights)
        ctx.save_for_backward(hidden, weight, bias, targets, lse,
                              row_weights)
        ctx.valid_vocab = valid_vocab
        return ce

    @staticmethod
    def backward(ctx, g):
        hidden, weight, bias, targets, lse, row_weights = ctx.saved_tensors
        b, s, d = hidden.shape
        dt = hidden.dtype
        h2 = hidden.reshape(b * s, d)
        t = targets.reshape(b * s).long()
        # recompute the logits, then overwrite them with dlogits in place
        dlogits = _logits(h2, weight, bias, ctx.valid_vocab)
        rows = torch.arange(b * s, device=h2.device)
        for start in range(0, b * s, _ROWS_PER_CHUNK):
            sl = slice(start, start + _ROWS_PER_CHUNK)
            p = torch.exp(dlogits[sl].float() - lse[sl, None])
            p[rows[sl] - start, t[sl]] -= 1.0
            dlogits[sl] = p.to(dt)
        if row_weights is not None:
            dlogits *= row_weights.to(dt).repeat_interleave(s)[:, None]
        scale = g / _n_eff(targets, row_weights)
        dhidden = (torch.matmul(dlogits, weight.to(dt)).float()
                   * scale).to(dt).view(b, s, d)
        dweight = (torch.matmul(dlogits.t(), h2).float()
                   * scale).to(weight.dtype)
        dbias = (dlogits.sum(0, dtype=torch.float32) * scale).to(bias.dtype)
        return dhidden, dweight, dbias, None, None, None


def fused_linear_cross_entropy(hidden: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, targets: torch.Tensor,
                               row_weights: Optional[torch.Tensor] = None,
                               valid_vocab: Optional[int] = None
                               ) -> torch.Tensor:
    """Mean token CE of ``softmax(hidden @ weightᵀ + bias)`` vs ``targets``.

    hidden: (B, S, D) compute-dtype activations (already shifted to align
    with ``targets``); weight: (V, D) and bias: (V,) of the LM head (f32
    parameters); targets: (B, S) ids; row_weights: optional (B,) 0/1 row
    weights (static-padding rows carry 0); valid_vocab: the true vocab size
    when V is padded. Returns the scalar mean over all weighted positions
    (the reference does not ignore padding, SCT-GAN/train.py:324)."""
    return _FusedLinearCE.apply(hidden, weight, bias, targets, row_weights,
                                valid_vocab)
