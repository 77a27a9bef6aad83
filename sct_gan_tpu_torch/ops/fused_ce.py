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

Under a mesh (``parallel/``):

  * ``vocab_axis`` (mp, the LM head column-parallel): this rank holds rows
    ``[rank·V/mp, (rank+1)·V/mp)`` of the head's weight; the row maxima,
    the sums of exponentials and the picked target logits are reduced over
    the axis (a vocab-parallel log-sum-exp), and the hidden and the bias
    enter through ``copy_to``, so their gradients are summed over it;
  * ``row_axis`` (dp): the rows are this rank's; the value is this rank's
    share of the global mean, its summed NLL over the global count.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import SINGLE, Axis, all_reduce_, copy_to

_ROWS_PER_CHUNK = 1024   # f32 rows of a (rows, V) chunk: ~200 MB at V = 50304


def _logits(hidden, weight, bias, valid_vocab, v0=0):
    """The logits of columns v0 .. v0 + V, pad columns at -inf."""
    dt = hidden.dtype
    logits = F.linear(hidden, weight.to(dt), bias.to(dt))
    if valid_vocab is not None and valid_vocab < v0 + logits.shape[-1]:
        logits[:, max(valid_vocab - v0, 0):] = float("-inf")
    return logits


def _n_eff(targets, row_weights, rows: Axis = SINGLE):
    """The count the mean divides by (over the global batch under dp): a
    host float, or a device scalar when rows are weighted (no host round
    trip either way)."""
    if row_weights is None:
        return float(targets.numel() * rows.size)
    total = all_reduce_(row_weights.float().sum(), rows)
    return torch.clamp_min(total * targets.shape[1], 1.0)


def _lse(logits, vocab: Axis):
    """f32 row log-sum-exp over the whole (possibly vocab-parallel) row,
    chunk by chunk."""
    chunks = logits.split(_ROWS_PER_CHUNK)
    if vocab.size == 1:     # torch's fused log-sum-exp, as before the mesh
        return torch.cat([torch.logsumexp(c.float(), dim=-1) for c in chunks])
    top = all_reduce_(torch.cat([c.float().amax(-1) for c in chunks]), vocab,
                      torch.distributed.ReduceOp.MAX)
    sums = torch.cat([torch.exp(c.float() - m[:, None]).sum(-1) for c, m in
                      zip(chunks, top.split(_ROWS_PER_CHUNK))])
    return top + torch.log(all_reduce_(sums, vocab))


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, bias, targets, row_weights, valid_vocab,
                vocab, rows):
        b, s, d = hidden.shape
        h2 = hidden.reshape(b * s, d)
        t = targets.reshape(b * s).long()
        v0 = vocab.rank * weight.shape[0]
        logits = _logits(h2, weight, bias, valid_vocab, v0)
        lse = _lse(logits, vocab)
        # the target's logit, from the rank that holds its column
        local = t - v0
        held = (local >= 0) & (local < weight.shape[0])
        picked = logits.gather(1, torch.where(held, local, 0)[:, None])
        picked = all_reduce_(torch.where(held, picked[:, 0].float(), 0.0),
                             vocab)
        nll = (lse - picked).view(b, s)
        if row_weights is None:
            ce = nll.sum() / _n_eff(targets, None, rows)
        else:
            ce = (nll * row_weights.float()[:, None]).sum() / _n_eff(
                targets, row_weights, rows)
        ctx.save_for_backward(hidden, weight, bias, targets, lse,
                              row_weights)
        ctx.valid_vocab, ctx.vocab, ctx.rows = valid_vocab, vocab, rows
        return ce

    @staticmethod
    def backward(ctx, g):
        hidden, weight, bias, targets, lse, row_weights = ctx.saved_tensors
        b, s, d = hidden.shape
        dt = hidden.dtype
        h2 = hidden.reshape(b * s, d)
        t = targets.reshape(b * s).long()
        v0, n = ctx.vocab.rank * weight.shape[0], weight.shape[0]
        # recompute the logits, then overwrite them with dlogits in place
        dlogits = _logits(h2, weight, bias, ctx.valid_vocab, v0)
        rows = torch.arange(b * s, device=h2.device)
        for start in range(0, b * s, _ROWS_PER_CHUNK):
            sl = slice(start, start + _ROWS_PER_CHUNK)
            p = torch.exp(dlogits[sl].float() - lse[sl, None])
            # only the rank holding the target's column subtracts its one
            local = t[sl] - v0
            held = (local >= 0) & (local < n)
            p[rows[sl] - start, torch.where(held, local, 0)] -= held.float()
            dlogits[sl] = p.to(dt)
        if row_weights is not None:
            dlogits *= row_weights.to(dt).repeat_interleave(s)[:, None]
        scale = g / _n_eff(targets, row_weights, ctx.rows)
        dhidden = (torch.matmul(dlogits, weight.to(dt)).float()
                   * scale).to(dt).view(b, s, d)
        dweight = (torch.matmul(dlogits.t(), h2).float()
                   * scale).to(weight.dtype)
        dbias = (dlogits.sum(0, dtype=torch.float32) * scale).to(bias.dtype)
        return dhidden, dweight, dbias, None, None, None, None, None


def fused_linear_cross_entropy(hidden: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, targets: torch.Tensor,
                               row_weights: Optional[torch.Tensor] = None,
                               valid_vocab: Optional[int] = None,
                               vocab_axis: Axis = SINGLE,
                               row_axis: Axis = SINGLE) -> torch.Tensor:
    """Mean token CE of ``softmax(hidden @ weightᵀ + bias)`` vs ``targets``.

    hidden: (B, S, D) compute-dtype activations (already shifted to align
    with ``targets``); weight: (V, D) and bias: (V,) of the LM head (f32
    parameters); targets: (B, S) ids; row_weights: optional (B,) 0/1 row
    weights (static-padding rows carry 0); valid_vocab: the true vocab size
    when V is padded. Returns the scalar mean over all weighted positions
    (the reference does not ignore padding, SCT-GAN/train.py:324).
    ``vocab_axis`` / ``row_axis``: see the module's docstring; ``weight``
    is then this rank's rows of the head and ``bias`` the whole bias."""
    n = weight.shape[0]
    hidden = copy_to(hidden, vocab_axis)
    bias = copy_to(bias, vocab_axis)[vocab_axis.rank * n:
                                     (vocab_axis.rank + 1) * n]
    return _FusedLinearCE.apply(hidden, weight, bias, targets, row_weights,
                                valid_vocab, vocab_axis, row_axis)
