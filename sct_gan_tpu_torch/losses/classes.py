"""Class-style loss wrappers of the port: ``sct_gan_tpu/losses/classes.py``
over the port's functional losses.

Constructor/call parity with the reference's nn.Module losses
(SCT-GAN/train.py:99-478), including the mutable α/γ/spatial_weight
attributes the trainer retunes between batches/epochs (train.py:1172-1182,
1558-1568). The math lives in the functional modules."""
from __future__ import annotations

from .focal import (contract_level_focal_loss, focal_loss,
                    spatial_aware_focal_loss)
from .syntax import SyntaxLossTables, solidity_syntax_loss


class FocalLoss:
    """FocalLoss(alpha=0.25, gamma=2.0) (train.py:99-115)."""

    def __init__(self, alpha: float = 0.25, gamma: float = 2.0,
                 reduction: str = "mean"):
        self.alpha = alpha
        self.gamma = gamma
        self.reduction = reduction

    def __call__(self, pred, target):
        return focal_loss(pred, target, alpha=self.alpha, gamma=self.gamma,
                          reduction=self.reduction)


class ContractLevelFocalLoss:
    """ContractLevelFocalLoss(alpha=0.05, gamma=4.0) with the 2× missed-
    vulnerability penalty (train.py:433-478)."""

    def __init__(self, alpha: float = 0.05, gamma: float = 4.0,
                 reduction: str = "mean"):
        self.alpha = alpha
        self.gamma = gamma
        self.reduction = reduction

    def __call__(self, pred, target):
        return contract_level_focal_loss(pred, target, alpha=self.alpha,
                                         gamma=self.gamma,
                                         reduction=self.reduction)


class SpatialAwareFocalLoss:
    """SpatialAwareFocalLoss with mutable alpha/gamma/spatial_weight
    (train.py:117-245). Accepts (B, S, C) tensors, or the reference's
    flattened (B·S, C) + (B·S,) calling convention."""

    def __init__(self, alpha: float = 0.25, gamma: float = 2.0,
                 spatial_weight: float = 0.2, reduction: str = "mean"):
        self.alpha = alpha
        self.gamma = gamma
        self.spatial_weight = spatial_weight
        self.reduction = reduction

    def __call__(self, pred, target, token_to_line=None):
        if pred.ndim == 2 and token_to_line is not None \
                and token_to_line.ndim == 1:
            # flattened convention: recover (B, S, C) with B inferred from
            # the token_to_line length (train.py:138-146)
            s = token_to_line.shape[0]
            if pred.shape[0] % s == 0 and pred.shape[0] != s:
                b = pred.shape[0] // s
                pred = pred.reshape(b, s, -1)
                target = target.reshape(b, s, -1)
                token_to_line = token_to_line[None].expand(b, -1)
            else:
                pred = pred[None]
                target = target[None]
                token_to_line = token_to_line[None]
        elif pred.ndim == 2:
            pred = pred[None]
            target = target[None]
        return spatial_aware_focal_loss(
            pred, target, token_to_line, alpha=self.alpha, gamma=self.gamma,
            spatial_weight=self.spatial_weight, reduction=self.reduction)


class SoliditySyntaxLoss:
    """SoliditySyntaxLoss(tokenizer, syntax_weight=0.5) (train.py:247-431)."""

    def __init__(self, tokenizer, syntax_weight: float = 0.5):
        self.tokenizer = tokenizer
        self.syntax_weight = syntax_weight
        self.tables = SyntaxLossTables.from_tokenizer(tokenizer)

    def __call__(self, logits, target_ids, _unused=None):
        total, _, _ = solidity_syntax_loss(logits, target_ids, self.tables,
                                           syntax_weight=self.syntax_weight)
        return total

    def _compute_simple_syntax_penalty(self, logits, target_ids):
        from .syntax import syntax_penalty
        return syntax_penalty(target_ids, self.tables)
