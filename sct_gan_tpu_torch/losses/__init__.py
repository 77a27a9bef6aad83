"""Loss functions of the port (``sct_gan_tpu/losses`` in PyTorch)."""
from .focal import (binary_cross_entropy_with_logits, contract_level_focal_loss,
                    focal_loss, masked_mean, spatial_aware_focal_loss)
from .syntax import (SyntaxLossTables, cross_entropy_loss,
                     solidity_syntax_loss, syntax_penalty)

__all__ = [
    "binary_cross_entropy_with_logits",
    "focal_loss",
    "masked_mean",
    "contract_level_focal_loss",
    "spatial_aware_focal_loss",
    "SyntaxLossTables",
    "cross_entropy_loss",
    "solidity_syntax_loss",
    "syntax_penalty",
]
