"""Attention ops: the plain PyTorch attention and the kernel dispatcher.

Counterpart of ``sct_gan_tpu/ops/attention.py``. Layouts follow the JAX
package: split heads ``(B, H, S, dh)`` and key masks with **True = attend**
(the inverse of torch's ``key_padding_mask``).

  * ``mha_reference`` — plain scaled-dot-product attention with PyTorch-MHA
    semantics (key mask, causal mask, attention-weight hash dropout,
    head-averaged weights). A fully-masked query row gives zeros, not NaN.
  * ``dot_product_attention`` — the device decides: a CPU tensor goes to the
    plain version, a CUDA tensor to the hand-written flash kernel (which
    raises on what it does not take). ``return_weights=True`` always takes
    the dense path, as in JAX, because the kernel never forms the weights.
"""
from __future__ import annotations

from typing import Optional

import torch

from .dropout import hash_keep

_NEG_INF = -1e30  # finite -inf stand-in: keeps fully-masked rows NaN-free


def _masked_scores(q, k, key_padding_mask, causal, sm_scale):
    """f32 scores Q Kᵀ·scale with masked entries at -1e30, and whether any
    entry is masked."""
    dh = q.shape[-1]
    scale = (1.0 / float(dh) ** 0.5) if sm_scale is None else float(sm_scale)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    sq, sk = scores.shape[-2], scores.shape[-1]
    masked = None
    if key_padding_mask is not None:
        masked = ~key_padding_mask.bool()[:, None, None, :]
    if causal:
        above = torch.ones(sq, sk, dtype=torch.bool,
                           device=q.device).triu(1)
        masked = above if masked is None else masked | above
    if masked is not None:
        scores = scores.masked_fill(masked, _NEG_INF)
    return scores, masked is not None


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  key_padding_mask: Optional[torch.Tensor] = None,
                  causal: bool = False,
                  dropout_rate: float = 0.0,
                  seed: int = 0,
                  return_weights: bool = False,
                  sm_scale: Optional[float] = None):
    """Scaled-dot-product attention over split heads.

    Args:
        q, k, v: (B, H, Sq|Sk, dh).
        key_padding_mask: (B, Sk) bool, True = attendable.
        causal: lower-triangular mask (query i sees keys j <= i).
        dropout_rate, seed: attention-weight dropout on the softmax
            weights, with the hash keep mask over the flat (B, H, Sq, Sk)
            index (``sct_gan_tpu/ops/attention.py:90-101``); 0 = none.
        return_weights: also return head-averaged weights (B, Sq, Sk),
            taken before dropout.
        sm_scale: softmax scale (1/sqrt(dh) by default).
    Returns:
        out (B, H, Sq, dh) in v.dtype [, weights (B, Sq, Sk) f32].

    Scores, softmax and the P·V accumulation are f32; P is rounded to
    v.dtype before P·V, as the JAX reference does.
    """
    scores, any_masked = _masked_scores(q, k, key_padding_mask, causal,
                                        sm_scale)
    weights = torch.softmax(scores, dim=-1)
    if any_masked:
        all_masked = scores.amax(dim=-1, keepdim=True) <= -1e29
        weights = weights.masked_fill(all_masked, 0.0)
    dropped = weights
    if dropout_rate > 0.0:
        keep = hash_keep(weights.numel(), seed, dropout_rate,
                         weights.device).view(weights.shape)
        dropped = torch.where(keep, weights / (1.0 - dropout_rate), 0.0)
    out = torch.matmul(dropped.to(v.dtype).float(), v.float()).to(v.dtype)
    if return_weights:
        return out, weights.mean(dim=1)
    return out


def attention_lse(q: torch.Tensor, k: torch.Tensor, *,
                  key_padding_mask: Optional[torch.Tensor] = None,
                  causal: bool = False,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, Sq) f32 log-sum-exp of each masked score row: the statistic
    the flash kernel keeps for its backward. A fully-masked row gives
    -1e30 (to f32 precision)."""
    scores, _ = _masked_scores(q, k, key_padding_mask, causal, sm_scale)
    return torch.logsumexp(scores, dim=-1)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, key_padding_mask: Optional[torch.Tensor] = None,
                          causal: bool = False,
                          dropout_rate: float = 0.0,
                          seed: int = 0,
                          return_weights: bool = False,
                          sm_scale: Optional[float] = None):
    """Attention over split heads; CPU → plain, CUDA → flash kernel."""
    if return_weights:
        return mha_reference(q, k, v, key_padding_mask=key_padding_mask,
                             causal=causal, dropout_rate=dropout_rate,
                             seed=seed, return_weights=True,
                             sm_scale=sm_scale)
    from .flash_attention import flash_attention
    return flash_attention(q, k, v, key_padding_mask=key_padding_mask,
                           causal=causal, sm_scale=sm_scale,
                           dropout_rate=dropout_rate, seed=seed)
