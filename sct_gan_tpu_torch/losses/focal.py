"""Focal-loss family of the port: ``sct_gan_tpu/losses/focal.py`` in PyTorch.

  * ``focal_loss`` — FocalLoss (SCT-GAN/train.py:99-115).
  * ``spatial_aware_focal_loss`` — SpatialAwareFocalLoss (train.py:117-245):
    focal + positive-prob encouragement + negative-prob discouragement +
    the ±2-line neighbourhood penalty, line-bucketed (``_spatial_penalty``).
  * ``contract_level_focal_loss`` — ContractLevelFocalLoss (train.py:433-478)
    with the 2× false-negative penalty.

α, γ and spatial_weight may be Python floats or 0-dim tensors on the
device (the trainer's per-batch retune keeps them there, so a step never
waits on the host).
"""
from __future__ import annotations

from typing import Optional

import torch


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE-with-logits (torch semantics, numerically stable)."""
    return (torch.clamp_min(logits, 0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def masked_mean(x: torch.Tensor,
                row_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over ``x`` counting only rows where ``row_mask`` (B,) is 1;
    exactly ``x.mean()`` with ``row_mask=None``. Static-padding rows of a
    ragged tail batch (trainer._pad_to_dp) carry 0."""
    if row_mask is None:
        return x.mean()
    m = row_mask.float()
    w = m.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    per_row = x.numel() // x.shape[0]
    return (x.float() * w).sum() / torch.clamp_min(m.sum() * per_row, 1.0)


def focal_loss(pred: torch.Tensor, target: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0,
               reduction: str = "mean") -> torch.Tensor:
    """FocalLoss (train.py:106-115): α·(1-pt)^γ·BCE, pt = exp(-BCE)."""
    bce = binary_cross_entropy_with_logits(pred, target)
    pt = torch.exp(-bce)
    fl = alpha * (1.0 - pt) ** gamma * bce
    if reduction == "mean":
        return fl.mean()
    if reduction == "sum":
        return fl.sum()
    return fl


def _band5(x: torch.Tensor) -> torch.Tensor:
    """out[:, l] = Σ_{|m-l|<=2} x[:, m] along dim 1 (edge-truncated)."""
    length = x.shape[1]
    pad = [0, 0] * (x.dim() - 2) + [2, 2]
    p = torch.nn.functional.pad(x, pad)
    return sum(p[:, d:d + length] for d in range(5))


def _spatial_penalty(pred: torch.Tensor, target: torch.Tensor,
                     token_to_line: torch.Tensor) -> torch.Tensor:
    """±2-line neighbourhood penalty, line-bucketed: the neighbourhood sum
    over tokens is the 5-line banded sum of per-line bucket sums minus the
    token's own contribution. Bucketing and read-back are one-hot
    contractions, as in the JAX package."""
    b, s, c = pred.shape
    sig = torch.sigmoid(pred)
    ttl = torch.clamp(token_to_line.long(), 0, s - 1)
    line_ids = torch.arange(s, device=pred.device)
    oh = (ttl[:, :, None] == line_ids[None, None, :]).to(pred.dtype)

    def bucket(v):                                    # (B, S, C) -> (B, L, C)
        return torch.einsum("bsl,bsc->blc", oh, v)

    def take3(x):                                     # (B, L, C) -> (B, S, C)
        return torch.einsum("bsl,blc->bsc", oh, x)

    sig_band = _band5(bucket(sig))
    tgt_band = _band5(bucket(target))
    cnt_band = _band5(oh.sum(dim=1)[..., None])[..., 0]
    counts = take3(cnt_band[..., None])[..., 0] - 1.0          # exclude self
    nearby_sig = take3(sig_band) - sig
    nearby_tgt = take3(tgt_band) - target
    has_vuln = nearby_tgt.sum(dim=-1) > 0
    mean_sig = nearby_sig / torch.clamp_min(counts, 1.0)[..., None]
    return torch.where((has_vuln & (counts > 0))[..., None], mean_sig * 0.1,
                       torch.zeros((), dtype=pred.dtype, device=pred.device))


def spatial_aware_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                             token_to_line: Optional[torch.Tensor] = None,
                             alpha=0.25, gamma=2.0, spatial_weight=0.2,
                             reduction: str = "mean",
                             row_mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """SpatialAwareFocalLoss (train.py:129-172); pred/target (B, S, C)."""
    probs = torch.sigmoid(pred)
    bce = binary_cross_entropy_with_logits(pred, target)
    pt = torch.exp(-bce)
    fl = alpha * (1.0 - pt) ** gamma * bce
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    fl = fl + torch.where(target == 1.0, torch.relu(0.3 - probs) * 0.5, zero)
    fl = fl + torch.where(target == 0.0, torch.relu(probs - 0.5) * 0.2, zero)
    if token_to_line is not None:
        fl = fl + spatial_weight * _spatial_penalty(pred, target,
                                                    token_to_line)
    if reduction == "mean":
        return masked_mean(fl, row_mask)
    if reduction == "sum":
        return fl.sum()
    return fl


def contract_level_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                              alpha=0.05, gamma=4.0, reduction: str = "mean",
                              row_mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """ContractLevelFocalLoss (train.py:444-478): per-type focal with a 2×
    multiplier on missed vulnerabilities (target == 1 and prob < 0.5)."""
    probs = torch.sigmoid(pred)
    bce = binary_cross_entropy_with_logits(pred, target)
    pt = torch.exp(-bce)
    fl = alpha * (1.0 - pt) ** gamma * bce
    fl = fl * torch.where((target == 1.0) & (probs < 0.5), 2.0, 1.0)
    if reduction == "mean":
        return masked_mean(fl, row_mask)
    if reduction == "sum":
        return fl.sum()
    return fl
